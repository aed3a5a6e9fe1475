"""rald_torch's shared layers, radar-cube resize and geometry against
rald_tpu on the same inputs and the same (flax-initialized) weights.

Both sides run float32 with the highest matmul precision, so the only
differences are summation order: 1e-5 absolute and relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rald_torch.convert.flax_params as fp
from rald_torch import geometry as tgeo
from rald_torch.dsp.cfar_points import resize_linear_align_corners as t_resize
from rald_torch.nn import layers as tl
from rald_tpu import geometry as jgeo
from rald_tpu.dsp.cfar_points import resize_linear_align_corners as j_resize

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jl():
    """rald_tpu's flax layers, imported when a test needs them (flax is not
    installed where only the ``gpu`` tests are collected)."""
    from rald_tpu.nn import layers

    return layers


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


def _init(module, *args, seed=0):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def _load(module: torch.nn.Module, convert, p, **kw) -> torch.nn.Module:
    sd: dict = {}
    convert(p, "m", sd, **kw)
    module.load_state_dict({k[2:]: v for k, v in sd.items()})
    return module.eval()


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_point_fourier_basis_identical(jl):
    np.testing.assert_array_equal(tl.point_fourier_basis(48), jl.point_fourier_basis(48))


def test_point_embed(jl):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(2, 50, 3)).astype(np.float32)
    p = _init(jl.PointEmbed(dim=64), pts)
    mod = tl.PointEmbed(dim=64)
    mod.mlp.load_state_dict({"weight": torch.from_numpy(p["mlp"]["kernel"].T.copy()),
                             "bias": torch.from_numpy(p["mlp"]["bias"])})
    want = jl.PointEmbed(dim=64).apply({"params": p}, pts)
    _close(mod(torch.from_numpy(pts)), want)


@pytest.mark.parametrize("fused_kv,cross", [(True, False), (True, True), (False, False), (False, True)])
def test_attention_layouts(fused_kv, cross, jl):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 24)).astype(np.float32) if cross else None
    jmod = jl.Attention(heads=4, dim_head=8, fused_kv=fused_kv)
    p = _init(jmod, x, ctx)
    tmod = _load(tl.Attention(32, 24 if cross else None, heads=4, dim_head=8, fused_kv=fused_kv),
                 fp._attention, p, dit=not fused_kv)
    want = jmod.apply({"params": p}, x, ctx)
    got = tmod(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    _close(got, want)


@pytest.mark.parametrize("dit_style", [False, True])
def test_geglu_feedforward(dit_style, jl):
    rng = np.random.default_rng(2)
    x = (3 * rng.normal(size=(2, 9, 32))).astype(np.float32)  # gates well into GELU's tails
    jmod = jl.GEGLUFeedForward()
    p = _init(jmod, x)
    tmod = _load(tl.GEGLUFeedForward(32, dit_style=dit_style), fp._geglu_ff, p, dit=dit_style)
    _close(tmod(torch.from_numpy(x)), jmod.apply({"params": p}, x))


def test_ada_layer_norm_mod_and_apply(jl):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32) * 2 + 0.5
    t_emb = rng.normal(size=(2, 1, 32)).astype(np.float32)
    jmod = jl.AdaLayerNorm(dim=32)
    p = _init(jmod, x, t_emb)
    tmod = tl.AdaLayerNorm(32)
    fp._linear(p["mod"], "linear", sd := {})
    tmod.load_state_dict(sd)
    j_s, j_b = jmod.apply({"params": p}, t_emb, method="mod")
    t_s, t_b = tmod.mod(torch.from_numpy(t_emb))
    _close(t_s, j_s)
    _close(t_b, j_b)
    want = jmod.apply({"params": p}, x, j_s, j_b, method="apply_mod")
    _close(tmod.apply_mod(torch.from_numpy(x), t_s, t_b), want)
    _close(tmod(torch.from_numpy(x), torch.from_numpy(t_emb)), jmod.apply({"params": p}, x, t_emb))


def test_layer_norm_f32_statistics():
    import flax.linen as nn

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 32)) * 4 + 7).astype(np.float32)
    jmod = nn.LayerNorm(epsilon=1e-5)
    p = _init(jmod, x)
    tmod = tl.LayerNorm(32)
    fp._norm(p, "n", sd := {})
    tmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    _close(tmod(torch.from_numpy(x)), jmod.apply({"params": p}, x))


def test_fourier_time_embedding_cos_first(jl):
    t = np.array([-3.1, -0.4, 0.0, 0.9, 1.1], np.float32)
    want = jl.FourierTimeEmbedding(64).apply({}, t)
    got = tl.FourierTimeEmbedding(64)(torch.from_numpy(t))
    _close(got, want)
    np.testing.assert_allclose(got[2, :32].numpy(), 1.0)  # cos(0) half comes first


def test_resize_linear_align_corners_product_shape():
    """(B, 128, 8, 2, C) -> (B, 128, 64, 32, C) as gen_engine.py:352-358."""
    rng = np.random.default_rng(5)
    cube = rng.normal(size=(2, 128, 8, 2, 3)).astype(np.float32)
    want = j_resize(jnp.asarray(cube), (64, 32), axes=(2, 3))
    got = t_resize(torch.from_numpy(cube), (64, 32), axes=(2, 3))
    assert got.shape == (2, 128, 64, 32, 3)
    _close(got, want)


@pytest.mark.parametrize("n_in,n_out", [(1, 5), (5, 1), (4, 4), (3, 7)])
def test_resize_edge_sizes(n_in, n_out):
    x = np.arange(2 * n_in, dtype=np.float32).reshape(2, n_in)
    want = j_resize(jnp.asarray(x), (n_out,), axes=(1,))
    _close(t_resize(torch.from_numpy(x), (n_out,), axes=(1,)), want)


PC_RANGE = [0, -90, -20, 15.8, 90, 20]


@pytest.mark.parametrize("aniso,iso", [(True, False), (False, True), (False, False), (True, True)])
def test_norm_and_inverse_norm_points(aniso, iso):
    rng = np.random.default_rng(6)
    pts = rng.uniform([0, -90, -20], [15.8, 90, 20], size=(4, 100, 3)).astype(np.float32)
    for fn_t, fn_j in ((tgeo.norm_points, jgeo.norm_points),
                       (tgeo.inverse_norm_points, jgeo.inverse_norm_points)):
        want = fn_j(pts, PC_RANGE, aniso, iso)
        np.testing.assert_allclose(fn_t(pts, PC_RANGE, aniso, iso), want, **TOL)  # numpy in
        _close(fn_t(torch.from_numpy(pts), PC_RANGE, aniso, iso), want)  # torch in
    off_t, sc_t = tgeo.norm_scale_offset(PC_RANGE)
    off_j, sc_j = jgeo.norm_scale_offset(PC_RANGE)
    np.testing.assert_array_equal(off_t, off_j)
    np.testing.assert_array_equal(sc_t, sc_j)


def test_polar2cartesian_numpy_and_torch():
    rng = np.random.default_rng(7)
    pts = rng.uniform([0, -90, -20], [15.8, 90, 20], size=(3, 200, 3)).astype(np.float32)
    want = np.asarray(jgeo.polar2cartesian(jnp.asarray(pts)))
    got_np = tgeo.polar2cartesian(pts)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, want, **TOL)
    got_t = tgeo.polar2cartesian(torch.from_numpy(pts))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), want, **TOL)


@pytest.mark.parametrize("block", ["resnet", "resnet_shortcut", "attn", "downsample"])
def test_radar_cnn_blocks(block):
    """The 3D-CNN's blocks (NDHWC in JAX, NCDHW inside the port):
    GroupNorm(gcd(32, ch), eps 1e-6), 'SAME' 3x3x3 convs, the (0, 1) pad
    before the stride-2 VALID conv."""
    from rald_torch.models import radar_encoder3d as tr
    from rald_tpu.models import radar_encoder3d as jr

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 5, 4, 16)).astype(np.float32)
    jmod, tmod, convert = {
        "resnet": (jr.ResnetBlock3D(), tr.ResnetBlock3D(16, 16), fp._resnet_block),
        "resnet_shortcut": (jr.ResnetBlock3D(out_channels=24), tr.ResnetBlock3D(16, 24),
                            fp._resnet_block),
        "attn": (jr.AttnBlock3D(), tr.AttnBlock3D(16), fp._attn_block3d),
        "downsample": (jr.Downsample3D(), tr.Downsample3D(16), None),
    }[block]
    p = _init(jmod, x)
    sd: dict = {}
    if convert is None:
        fp._conv3d(p["conv"], "m.conv", sd)
    else:
        convert(p, "m", sd)
    tmod.load_state_dict({k[2:]: v for k, v in sd.items()})
    want = jmod.apply({"params": p}, x)
    got = tmod(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape
    _close(got, want)
