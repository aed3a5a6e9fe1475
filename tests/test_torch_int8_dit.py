"""Quantized inference as a whole: the int8 side-tree, the DiT's int8
routing, the 35-NFE sampler, the activation-scale calibration and the
engine's configuration, rald_torch against rald_tpu on the tiny generation
config (flax ``model.init`` weights carried across, float32 on both sides).

The JAX side runs its Pallas kernels in interpret mode
(``pltpu.force_tpu_interpret_mode``), with ``model_eval`` of a copy of the
JAX engine swapped for the int8 model, as ``rald_tpu``'s own engine builds
it on a TPU; nothing in ``rald_tpu`` changes.

Tolerances: int8 codes and scales bitwise; one denoiser call 5e-3 of
max|out| (the kernels' bar: the two sides share every rounding point, and
an int8 code may flip at a .5 tie); 35 NFEs 1e-2 * max(rms, 1) on the
tokens (the chain compounds f32 summation-order differences through the
int8 grids); calibration tables rtol 1e-4."""
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY_CFG, jax_engine_and_params, tiny_cfg, torch_engine

REPO = Path(__file__).resolve().parent.parent
DEPTH = TINY_CFG["ar_model"]["overrides"]["depth"]
MODES = [(True, False), ("static", False), (False, "full"), (False, "vout"), (True, "vout"),
         ("static", True)]


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


def _inference(**kw):
    return dict(TINY_CFG["eval"]["inference"], **kw)


def _scales_npz(path, num_steps=18, depth=DEPTH, seed=0):
    rng = np.random.default_rng(seed)
    ah = rng.uniform(3.0, 6.0, size=(num_steps, depth)).astype(np.float32)
    ag = rng.uniform(1.0, 3.0, size=(num_steps, depth)).astype(np.float32)
    np.savez(path, ah=ah, ag=ag, num_steps=num_steps)
    return ah, ag


def _torch_int8_engine(params, vparams, ff, attn, tmp_path):
    inf = _inference(int8_ff=ff, int8_attn=attn)
    if ff == "static":
        inf["int8_act_scales"] = str(tmp_path / "scales.npz")
        _scales_npz(inf["int8_act_scales"])
    return torch_engine(params, vparams, eval={"inference": inf})


def _jax_int8_tree(params, ff, attn):
    from rald_tpu.ops.attn_kernel import merge_int8_trees, quantize_attn_tree
    from rald_tpu.ops.geglu_kernel import quantize_ff_tree

    q = quantize_ff_tree(params) if ff else {}
    return merge_int8_trees(q, quantize_attn_tree(params)) if attn else q


# ---------------------------------------------------------------- side-tree
def test_int8_side_tree_is_bitwise_jax():
    from rald_torch.convert.flax_params import edm_state_dict_from_flax
    from rald_torch.ops.attn_kernel import merge_int8_trees, quantize_attn_tree
    from rald_torch.ops.geglu_kernel import quantize_ff_tree

    _, params, _ = jax_engine_and_params(0)
    j = _jax_int8_tree(params, True, True)
    sd = edm_state_dict_from_flax(params, depth=DEPTH)
    t = merge_int8_trees(quantize_ff_tree(sd), quantize_attn_tree(sd))
    assert sorted(t) == sorted([f"model.transformer_blocks.{i}.{k}" for i in range(DEPTH)
                                for k in ("ff", "attn1")])
    for i in range(DEPTH):
        jb, tb = j["model"][f"block_{i}"], f"model.transformer_blocks.{i}"
        pairs = [(t[f"{tb}.ff"][k], jb["ff"][k]) for k in ("w1q", "s1", "w2q", "s2")]
        pairs += [(t[f"{tb}.attn1"][k], jb["attn1"][k]) for k in jb["attn1"]]
        for got, want in pairs:
            want = np.asarray(want)
            got = got.numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got.T if got.ndim == 2 else got[None], want)
        np.testing.assert_array_equal(t[f"{tb}.attn1"]["to_out_b"].numpy(),
                                      params["model"][f"block_{i}"]["attn1"]["to_out"]["bias"])
        np.testing.assert_array_equal(t[f"{tb}.ff"]["b2"].numpy(),
                                      params["model"][f"block_{i}"]["ff"]["proj_out"]["bias"])


def test_merge_int8_trees_is_deep():
    from rald_torch.ops.attn_kernel import merge_int8_trees

    a = {"x": {"ff": 1}, "y": 2}
    b = {"x": {"attn1": 3}, "z": 4}
    assert merge_int8_trees(a, b) == {"x": {"ff": 1, "attn1": 3}, "y": 2, "z": 4}
    assert a == {"x": {"ff": 1}, "y": 2}


def test_gelu_poly_matches_jax():
    from rald_torch.ops.geglu_kernel import _erf_poly, _gelu_poly
    from rald_tpu.ops.geglu_kernel import _erf_poly as j_erf
    from rald_tpu.ops.geglu_kernel import _gelu_poly as j_gelu

    x = np.linspace(-12.0, 12.0, 20001, dtype=np.float32)
    np.testing.assert_allclose(_erf_poly(torch.from_numpy(x)).numpy(), np.asarray(j_erf(x)),
                               rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(_gelu_poly(torch.from_numpy(x)).numpy(), np.asarray(j_gelu(x)),
                               rtol=0, atol=2.4e-6)


def test_port_imports_with_jax_and_rald_tpu_blocked(tmp_path):
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "rald_torch").rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'rald_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import rald_torch\n"
        + "".join(f"import {m}\n" for m in modules)
        + "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert "rald_torch.ops.attn_kernel" in modules


# ------------------------------------------------------------ the denoiser
@pytest.fixture(scope="module")
def jax_side():
    return jax_engine_and_params(0)


def _denoise_inputs(jeng, params, teng, sigma, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 16, 8)) * max(sigma, 1.0)).astype(np.float32)
    cube = rng.normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    sig = np.array([sigma], np.float32)
    j_cond = jeng.model.apply({"params": params}, jnp.asarray(cube), method="process_radar_cond")
    j_mods = jeng.model.apply({"params": params}, jnp.asarray(sig), method="compute_mod_table")
    t_cond = teng.model.process_radar_cond(torch.from_numpy(cube))
    t_mods = teng.model.compute_mod_table(torch.from_numpy(sig))
    return x, sig, (j_cond, j_mods), (t_cond, t_mods)


def _block_scales(teng, x, sig, t_mods, t_cond):
    """Per-block (ah, ag): the unfused denoiser's own amax, halved for the
    gated product so that some of it saturates."""
    stats = []
    teng.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods, t_cond,
                                 quant_stats=stats)
    return [(float(h), 0.5 * float(g)) for h, g in stats]


@pytest.mark.parametrize("ff,attn", MODES)
def test_denoise_with_mods_int8_matches_jax(jax_side, tmp_path, ff, attn):
    from jax.experimental.pallas import tpu as pltpu

    jeng, params, vparams = jax_side
    teng = _torch_int8_engine(params, vparams, ff, attn, tmp_path)
    x, sig, (j_cond, j_mods), (t_cond, t_mods) = _denoise_inputs(jeng, params, teng, 1.3, seed=1)
    scales = _block_scales(teng, x, sig, t_mods, t_cond) if ff == "static" else None
    jm = jeng.model.copy(use_fused_ff=True, use_int8_ff=ff, use_int8_attn=attn)
    j_sc = None if scales is None else tuple(
        (jnp.float32(h), jnp.float32(g)) for h, g in scales)
    # jitted: eager dispatch beside the interpreter's io_callbacks can deadlock
    denoise = jax.jit(lambda v, *a: jm.apply(v, *a, method="denoise_with_mods",
                                             act_scales=j_sc))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(denoise({"params": params, "int8": _jax_int8_tree(params, ff, attn)},
                                  jnp.asarray(x), jnp.asarray(sig), j_mods, j_cond))
    t_sc = None if scales is None else tuple(
        (torch.tensor(h), torch.tensor(g)) for h, g in scales)
    got = teng.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods,
                                       t_cond, act_scales=t_sc).numpy()
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    # the int8 path really ran: it moves the output off the bf16/f32 path
    plain = teng.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods,
                                         t_cond, quant_stats=[]).numpy()
    assert np.abs(got - plain).max() > 1e-5


def test_static_without_scales_is_dynamic(jax_side, tmp_path):
    jeng, params, vparams = jax_side
    t_sta = _torch_int8_engine(params, vparams, "static", False, tmp_path)
    t_dyn = _torch_int8_engine(params, vparams, True, False, tmp_path)
    x, sig, _, (t_cond, t_mods) = _denoise_inputs(jeng, params, t_sta, 0.5, seed=2)
    a = t_sta.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods, t_cond)
    b = t_dyn.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods, t_cond)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    sc = tuple((torch.tensor(4.0), torch.tensor(1.0)) for _ in range(DEPTH))
    c = t_sta.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods, t_cond,
                                      act_scales=sc)
    assert (c - a).abs().max() > 0  # the scales are in use


# --------------------------------------------------------------- the chain
@pytest.mark.parametrize("ff,attn", [(True, "vout"), ("static", "full")])
def test_35_nfe_sampler_int8_matches_jax(jax_side, tmp_path, ff, attn):
    from jax.experimental.pallas import tpu as pltpu

    from rald_tpu.diffusion.edm import sample_prior_latents

    jeng, params, vparams = jax_side
    teng = _torch_int8_engine(params, vparams, ff, attn, tmp_path)
    j2 = copy.copy(jeng)
    j2.model_eval = jeng.model.copy(use_fused_ff=True, use_int8_ff=ff, use_int8_attn=attn)
    if ff == "static":
        with np.load(tmp_path / "scales.npz") as z:
            j2._act_scales = jnp.stack([jnp.asarray(z["ah"]), jnp.asarray(z["ag"])], axis=-1)
    cube = np.random.default_rng(4).normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    seeds = jnp.arange(2)
    prior = np.asarray(sample_prior_latents(seeds, 16, 8))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(j2._sample_impl)(params, jnp.asarray(cube), seeds))
    got = teng.sample_tokens(cube, prior).numpy()
    assert got.shape == want.shape == (2, 16, 8)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert np.abs(want).max() > 1.0  # the chain did real work
    assert np.abs(got - want).max() <= 1e-2 * max(rms, 1.0)


def test_calibrate_act_scales_matches_jax(jax_side):
    from rald_tpu.diffusion.edm import sample_prior_latents

    jeng, params, vparams = jax_side
    teng = torch_engine(params, vparams)
    # cube seed 4: the tiny encoder's last GroupNorm normalises 1 channel x 2
    # positions, which turns f32 noise into condition-token differences of
    # up to 5 % on some cubes (seeds 1, 5); on this one the tokens agree to
    # 2.4e-7
    cube = np.random.default_rng(4).normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    lidar = np.zeros((2, 8, 3), np.float32)
    j_ah, j_ag = jeng.calibrate_act_scales(
        params, [{"radar_cube": cube, "lidar_points": lidar}], num_batches=1, margin=1.1,
        print_fn=lambda *_: None)
    prior = np.asarray(sample_prior_latents(jnp.arange(2), 16, 8))
    t_ah, t_ag = teng.calibrate_act_scales([{"radar_cube": cube, "seeds_or_prior": prior}],
                                           num_batches=1, margin=1.1, print_fn=lambda *_: None)
    assert t_ah.shape == t_ag.shape == (18, DEPTH) and t_ah.dtype == np.float32
    assert (t_ah > 0).all() and (t_ag > 0).all()
    np.testing.assert_allclose(t_ah, j_ah, rtol=1e-4)
    np.testing.assert_allclose(t_ag, j_ag, rtol=1e-4)


def test_calibrate_act_scales_default_seeds_and_refusals(jax_side):
    jeng, params, vparams = jax_side
    teng = torch_engine(params, vparams)
    cube = np.random.default_rng(6).normal(size=(1, 32, 16, 16, 3)).astype(np.float32)
    lines = []
    batches = [{"radar_cube": cube}, {"radar_cube": cube}, {"radar_cube": cube}]
    ah, ag = teng.calibrate_act_scales(batches, num_batches=2, print_fn=lines.append)
    assert lines == ["calibrate_act_scales: batch 1/2 done", "calibrate_act_scales: batch 2/2 done"]
    one, _ = teng.calibrate_act_scales(batches[:1], num_batches=1, print_fn=lines.append)
    assert (ah >= one).all() and (ah > one).any()  # batch 2 draws from seed 1, not seed 0
    with pytest.raises(ValueError, match="empty loader"):
        teng.calibrate_act_scales([], print_fn=lines.append)
    teng.sampler_kwargs["s_churn"] = 1.0
    try:
        with pytest.raises(ValueError, match="churn"):
            teng.calibrate_act_scales(batches, print_fn=lines.append)
    finally:
        teng.sampler_kwargs["s_churn"] = 0.0


# ------------------------------------------------------------ configuration
def _engine(tmp_path, **inference):
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    return GenerationEngine(tiny_cfg(Config, eval={"inference": _inference(**inference)}),
                            device="cpu")


@pytest.mark.parametrize("ff", [False, True, "static"])
@pytest.mark.parametrize("attn", [False, True, "full", "vout"])
def test_engine_runs_every_int8_mode(tmp_path, ff, attn):
    from rald_torch.ops import launch_counts, reset_launch_counts

    kw = dict(int8_ff=ff, int8_attn=attn, num_steps=3)
    if ff == "static":
        kw["int8_act_scales"] = str(tmp_path / "s.npz")
        _scales_npz(kw["int8_act_scales"], num_steps=3)
    eng = _engine(tmp_path, **kw)
    block = eng.model.model.transformer_blocks[0]
    assert set(block.int8) == {k for k, on in (("ff", ff), ("attn1", attn)) if on}
    reset_launch_counts()
    tok = eng.sample_tokens(np.zeros((1, 32, 16, 16, 3), np.float32), [0])
    assert tok.shape == (1, 16, 8) and torch.isfinite(tok).all()
    assert all(v == 0 for v in launch_counts().values())  # CPU: plain versions only


@pytest.mark.parametrize("key,value,match", [
    ("int8_ff", "dynamic", "int8_ff must be bool or 'static'"),
    ("int8_ff", 2, "int8_ff must be bool or 'static'"),
    ("int8_attn", "qk", "int8_attn must be bool, 'full' or 'vout'"),
])
def test_engine_rejects_bad_int8_values(tmp_path, key, value, match):
    with pytest.raises(ValueError, match=match):
        _engine(tmp_path, **{key: value})


def test_act_scales_loader_errors(tmp_path):
    with pytest.raises(ValueError, match="needs calibrated activation scales"):
        _engine(tmp_path, int8_ff="static")
    with pytest.raises(FileNotFoundError, match="no activation scales"):
        _engine(tmp_path, int8_ff="static", int8_act_scales=str(tmp_path / "missing.npz"))
    path = str(tmp_path / "s.npz")
    _scales_npz(path, num_steps=10)
    with pytest.raises(ValueError, match="num_steps=10.*recalibrate"):
        _engine(tmp_path, int8_ff="static", int8_act_scales=path)
    ah = np.ones((18, DEPTH), np.float32)
    np.savez(path, ah=ah, ag=ah, num_steps=12)
    with pytest.raises(ValueError, match="calibrated for num_steps=12"):
        _engine(tmp_path, int8_ff="static", int8_act_scales=path)
    _scales_npz(path, depth=DEPTH + 1)
    with pytest.raises(ValueError, match="cover 3 blocks, model has depth 2"):
        _engine(tmp_path, int8_ff="static", int8_act_scales=path)


def test_act_scales_default_path_and_table(tmp_path):
    ah, ag = _scales_npz(tmp_path / "int8_act_scales.npz")
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = tiny_cfg(Config, eval={"inference": _inference(int8_ff="static"),
                                 "ckpt": str(tmp_path)})
    eng = GenerationEngine(cfg, device="cpu")
    table = eng._act_scales.numpy()
    assert table.shape == (18, DEPTH, 2)
    np.testing.assert_array_equal(table[..., 0], ah)
    np.testing.assert_array_equal(table[..., 1], ag)


def test_side_tree_comes_from_f32_weights(jax_side):
    """In bf16 the model is cast, but the codes are those of the f32
    weights (JAX quantizes the f32 parameters)."""
    from rald_torch.ops.geglu_kernel import quantize_cols

    jeng, params, vparams = jax_side
    eng = torch_engine(params, vparams, system={"compute_dtype": "bfloat16"},
                       eval={"inference": _inference(int8_ff=True, int8_attn="vout")})
    block = eng.model.model.transformer_blocks[1]
    assert block.ff.proj_in.weight.dtype == torch.bfloat16
    w1 = params["model"]["block_1"]["ff"]["proj_in"]["kernel"]
    want, _ = quantize_cols(torch.from_numpy(np.array(w1.T)))
    torch.testing.assert_close(block.int8["ff"]["w1q"], want, rtol=0, atol=0)
    from_bf16, _ = quantize_cols(block.ff.proj_in.weight)
    assert (from_bf16 != want).any()
    assert block.int8["ff"]["b1"].dtype == torch.float32
    assert set(block.int8["attn1"]) >= {"to_v_q", "to_out_q", "to_out_b"}
