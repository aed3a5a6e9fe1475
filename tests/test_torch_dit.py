"""The latent DiT + EDM preconditioner: rald_torch against rald_tpu on the
tiny generation config (flax ``model.init`` weights carried across), plus
one full-width (dim 512, 8 x 64 heads, 512 tokens) ``LatentDiTBlock``.

Both sides float32 at the highest matmul precision; the port's FF sublayer
runs the plain version of the fused kernel and the JAX side the unfused
flax modules, so sums differ in order through several sublayers: 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rald_torch.convert.flax_params as fp
from torch_parity import jax_engine_and_params, torch_engine

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def engines():
    jeng, params, vparams = jax_engine_and_params(0)
    return jeng, params, torch_engine(params, vparams)


def _cube(bsz=2, seed=0):
    return np.random.default_rng(seed).normal(size=(bsz, 32, 16, 16, 3)).astype(np.float32)


def test_process_radar_cond(engines):
    jeng, params, teng = engines
    cube = _cube()
    want = jeng.model.apply({"params": params}, jnp.asarray(cube), method="process_radar_cond")
    got = teng.model.process_radar_cond(torch.from_numpy(cube))
    assert got.shape == want.shape == (2, 2, 32)  # (B, R'*A'*E', radar_token_channel)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_engine_condition_matches_model(engines):
    _, _, teng = engines
    cube = _cube(seed=1)
    got = teng.condition(cube)
    want = teng.model.process_radar_cond(torch.from_numpy(cube))
    torch.testing.assert_close(got, want)


def test_compute_mod_table(engines):
    from rald_torch.diffusion.edm import karras_sigmas as t_sigmas
    from rald_tpu.diffusion.edm import karras_sigmas as j_sigmas

    jeng, params, teng = engines
    j_tab = jeng.model.apply({"params": params}, j_sigmas(18)[:-1], method="compute_mod_table")
    t_tab = teng.model.compute_mod_table(t_sigmas(18)[:-1])
    assert len(t_tab) == len(j_tab) == 2  # depth
    for t_block, j_block in zip(t_tab, j_tab):
        for (ts, tb), (js, jb) in zip(t_block, j_block):
            assert ts.shape == js.shape == (18, 1, 32)
            np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **TOL)
            np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("sigma", [80.0, 1.3, 0.002])
def test_denoise_with_mods(engines, sigma):
    jeng, params, teng = engines
    rng = np.random.default_rng(int(sigma * 10))
    x = (rng.normal(size=(2, 16, 8)) * max(sigma, 1.0)).astype(np.float32)
    cube = _cube(seed=2)
    sig = np.array([sigma], np.float32)
    j_cond = jeng.model.apply({"params": params}, jnp.asarray(cube), method="process_radar_cond")
    j_mods = jeng.model.apply({"params": params}, jnp.asarray(sig), method="compute_mod_table")
    want = jeng.model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sig), j_mods, j_cond,
                            method="denoise_with_mods")
    t_cond = teng.model.process_radar_cond(torch.from_numpy(cube))
    t_mods = teng.model.compute_mod_table(torch.from_numpy(sig))
    got = teng.model.denoise_with_mods(torch.from_numpy(x), torch.from_numpy(sig), t_mods, t_cond)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # the hoisted-mods path equals the plain denoiser
    plain = teng.model.denoise(torch.from_numpy(x), torch.from_numpy(sig), t_cond)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


def test_full_width_dit_block():
    """One product-width block: dim 512, 8 heads x 64, 512 latent tokens,
    cross-attention to 64 condition tokens of width 512."""
    from rald_torch.models.latent_dit import LatentDiTBlock as TBlock
    from rald_tpu.models.latent_dit import LatentDiTBlock as JBlock

    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 512, 512)).astype(np.float32)
    t_emb = rng.normal(size=(1, 1, 512)).astype(np.float32)
    cond = rng.normal(size=(1, 64, 512)).astype(np.float32)
    jblock = JBlock(n_heads=8, d_head=64)
    p = jax.jit(jblock.init)(jax.random.PRNGKey(0), x, t_emb, cond)["params"]
    p = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)
    sd: dict = {}
    for k in (1, 2, 3):
        fp._linear(p[f"norm{k}"]["mod"], f"norm{k}.linear", sd)
    fp._attention(p["attn1"], "attn1", sd, dit=True)
    fp._attention(p["attn2"], "attn2", sd, dit=True)
    fp._geglu_ff(p["ff"], "ff", sd, dit=True)
    tblock = TBlock(512, 8, 64, context_dim=512)
    tblock.load_state_dict(sd)
    want = jax.jit(lambda *a: jblock.apply({"params": p}, *a))(x, t_emb, cond)
    got = tblock(torch.from_numpy(x), torch.from_numpy(t_emb), torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
