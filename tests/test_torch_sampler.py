"""The EDM Heun sampler: the whole 18-step / 35-NFE chain of rald_torch
against rald_tpu's engine on the tiny model, fed the same prior draw (JAX's
per-seed stream, injected into the port as numpy): as the YAML ships, with
``system.fast_inference: false`` (then also the unfolded decode) and with
``ar_model.overrides: {use_fused_attn: true}``.

Stochastic churn (``eval.inference.s_churn > 0``): ``edm_sampler`` against
JAX's on a toy denoiser with JAX's per-(seed, step) churn draws injected
(1e-5 of max|x|), the engine's chain against JAX's ``_sample_impl`` with
JAX's prior and churn draws injected, and the port's own churn draws
(unit normal, independent across steps and samples, a frame's draws and
tokens the same alone as in a batch).

Float32 on both sides; 35 NFEs compound summation-order differences, and
the tokens end O(1)-O(10): 1e-3 absolute."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.diffusion import edm as tedm
from rald_tpu.diffusion import edm as jedm
from torch_parity import TINY_CFG, jax_engine_and_params, torch_engine


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


def test_karras_sigmas_match():
    for n in (18, 4):
        np.testing.assert_allclose(tedm.karras_sigmas(n).numpy(), np.asarray(jedm.karras_sigmas(n)),
                                   rtol=1e-6)
    assert float(tedm.karras_sigmas(18)[-1]) == 0.0


def test_stack_unstack_mod_table_round_trip():
    rng = np.random.default_rng(0)
    f = lambda: rng.normal(size=(5, 1, 4)).astype(np.float32)
    table = tuple(tuple((f(), f()) for _ in range(3)) for _ in range(2))
    t_st = tedm.stack_mod_table(
        tuple(tuple((torch.from_numpy(s), torch.from_numpy(b)) for s, b in blk) for blk in table))
    j_st = jedm.stack_mod_table(
        tuple(tuple((jnp.asarray(s), jnp.asarray(b)) for s, b in blk) for blk in table))
    assert t_st.shape == j_st.shape == (5, 2, 3, 2, 1, 4)
    np.testing.assert_array_equal(t_st.numpy(), np.asarray(j_st))
    for blk, (mods_t, blk_np) in enumerate(zip(tedm.unstack_mods(t_st[3]), table)):
        for (s, b), (s_np, b_np) in zip(mods_t, blk_np):
            np.testing.assert_array_equal(s.numpy(), s_np[3])
            np.testing.assert_array_equal(b.numpy(), b_np[3])


def _jax_churn_eps(seeds, step, shape):
    """JAX's churn draw of one Heun step: ``normal(fold_in(key(seed), step))``
    per sample (``rald_tpu/diffusion/edm.py:132-143``)."""
    keys = jax.vmap(lambda k: jax.random.fold_in(k, step))(jedm.per_sample_keys(jnp.asarray(seeds)))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


# (s_churn, s_min, s_max): gamma at the sqrt(2) - 1 cap inside a window that
# leaves out the first steps and the final ones; gamma below the cap on every
# step, the final Euler step included; the cap on every step
CHURN_CASES = [(40.0, 0.05, 50.0), (3.0, 0.0, float("inf")), (100.0, 0.0, float("inf"))]


@pytest.mark.parametrize("s_churn,s_min,s_max", CHURN_CASES)
def test_churn_sampler_matches_jax(s_churn, s_min, s_max):
    seeds, shape = [3, 11], (6, 4)
    latents = np.random.default_rng(0).standard_normal((2,) + shape).astype(np.float32)
    kw = dict(num_steps=18, s_churn=s_churn, s_min=s_min, s_max=s_max, s_noise=1.003)

    def toy(x, sigma, xp):
        return x / (1 + sigma ** 2) + 0.1 * xp.tanh(x)

    # op by op: compiled, XLA's CPU backend fuses t_hat**2 - t_cur**2 into an
    # FMA, which leaves sqrt(|rounding error of t_cur**2|) ~ 1e-2 of churn
    # noise on steps where gamma is 0 (the port adds none, as the formula says)
    with jax.disable_jit():
        want, (j_idx, j_xs) = jedm.edm_sampler(
            lambda x, s: toy(x, s, jnp), jnp.asarray(latents), capture_states=True,
            noise_keys=jedm.per_sample_keys(jnp.asarray(seeds)), **kw)
    steps = []

    def noise(step):
        steps.append(step)
        return torch.from_numpy(_jax_churn_eps(seeds, step, shape).copy())

    got, (t_idx, t_xs) = tedm.edm_sampler(lambda x, s, i: toy(x, s, torch), torch.from_numpy(latents),
                                          churn_noise=noise, capture_states=True, **kw)
    assert steps == list(range(18))  # the final Euler step churns too
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    scale = float(np.abs(np.asarray(j_xs)).max())
    assert np.abs(t_xs.numpy() - np.asarray(j_xs)).max() <= 1e-5 * scale
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
    plain = jedm.edm_sampler(lambda x, s: toy(x, s, jnp), jnp.asarray(latents), num_steps=18)
    assert np.abs(np.asarray(plain) - np.asarray(want)).max() > 1e-2  # the churn did move it


def test_churn_needs_its_noise():
    with pytest.raises(ValueError, match="churn_noise"):
        tedm.edm_sampler(lambda x, s, i: x, torch.zeros(1, 2, 2), s_churn=1.0)


def test_churn_draws_are_unit_normal_and_independent():
    a = tedm.sample_churn_noise(list(range(8)), 0, 512, 32, "cpu")
    b = tedm.sample_churn_noise(list(range(8)), 1, 512, 32, "cpu")
    assert a.shape == (8, 512, 32) and a.dtype == torch.float32
    for t in (a, b):
        assert abs(float(t.mean())) < 0.01 and abs(float(t.std()) - 1) < 0.01
    flat = lambda t: t.reshape(-1)
    for x, y in ((a[0], a[1]), (a[0], b[0]), (a[0], tedm.sample_prior_latents([0], 512, 32, "cpu")[0])):
        assert abs(float(torch.corrcoef(torch.stack([flat(x), flat(y)]))[0, 1])) < 0.02
    alone = tedm.sample_churn_noise([5], 1, 512, 32, "cpu")
    torch.testing.assert_close(alone[0], b[5], rtol=0, atol=0)
    with pytest.raises(ValueError, match="injected prior"):
        tedm.sample_churn_noise(np.zeros((1, 4, 8), np.float32), 0, 4, 8, "cpu")


def test_prior_from_seeds_is_per_frame():
    a = tedm.sample_prior_latents([3, 5], 16, 8, "cpu")
    b = tedm.sample_prior_latents([5], 16, 8, "cpu")
    assert a.shape == (2, 16, 8)
    torch.testing.assert_close(a[1], b[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="injected prior"):
        tedm.sample_prior_latents(np.zeros((1, 4, 8), np.float32), 16, 8, "cpu")


def test_sampler_counts_35_nfes_with_paired_rows():
    calls = []

    def denoise(x, sigma, idx):
        calls.append(idx)
        return x * 0.5

    tedm.edm_sampler(denoise, torch.ones(1, 2, 2), num_steps=18)
    assert len(calls) == 35
    assert calls[:4] == [0, 1, 1, 2] and calls[-1] == 17


@functools.lru_cache(maxsize=None)
def _jax_chain(use_fused_attn: bool = False):
    """(cube, prior, tokens) of the JAX engine's 35-NFE chain on cube seed 4
    (the tiny encoder conditions it to 1e-6), its Pallas attention kernel
    interpreted when ``use_fused_attn``. Cached per process."""
    from jax.experimental.pallas import tpu as pltpu

    jeng, params, _ = jax_engine_and_params(0)
    cube = np.random.default_rng(4).normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    seeds = jnp.arange(2)
    prior = np.asarray(jedm.sample_prior_latents(seeds, 16, 8))
    with jax.default_matmul_precision("highest"):
        if not use_fused_attn:
            return cube, prior, np.asarray(jeng._sample(params, jnp.asarray(cube), seeds))
        j2 = copy.copy(jeng)
        j2.model_eval = jeng.model.copy(use_fused_attn=True)
        with pltpu.force_tpu_interpret_mode():
            return cube, prior, np.asarray(jax.jit(j2._sample_impl)(params, jnp.asarray(cube),
                                                                     seeds))


def test_full_35_nfe_chain_matches_jax():
    _, params, vparams = jax_engine_and_params(0)
    teng = torch_engine(params, vparams)
    cube, prior, want = _jax_chain()
    got = teng.sample_tokens(cube, prior)
    assert got.shape == want.shape == (2, 16, 8)
    assert np.abs(want).max() > 1.0  # the chain did real work
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_35_nfe_chain_use_fused_attn_matches_jax():
    """``ar_model.overrides: {use_fused_attn: true}`` is accepted, kept in
    the eval model, and reaches every block at every NFE."""
    from rald_torch.ops import attn_kernel

    _, params, vparams = jax_engine_and_params(0)
    overrides = dict(TINY_CFG["ar_model"]["overrides"], use_fused_attn=True)
    teng = torch_engine(params, vparams, ar_model={"overrides": overrides})
    blocks = teng.model.model.transformer_blocks
    assert all(b.use_fused_attn and b.use_fused_ff for b in blocks)
    cube, prior, want = _jax_chain(use_fused_attn=True)
    calls = []
    plain = attn_kernel.fused_self_attention_block_plain
    attn_kernel.fused_self_attention_block_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        got = teng.sample_tokens(cube, prior)
    finally:
        attn_kernel.fused_self_attention_block_plain = plain
    assert len(calls) == 35 * len(blocks)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_fast_inference_off_matches_jax_engine():
    """``system.fast_inference: false``: the plain DiT modules and the
    unfolded VAE decode, against JAX's engine on the CPU, which runs
    unfused there (and decodes unfolded without fast_inference)."""
    jeng, params, vparams = jax_engine_and_params(0)
    teng = torch_engine(params, vparams, system={"fast_inference": False})
    assert not teng.model.model.transformer_blocks[0].use_fused_ff
    assert not teng.vae.fold_decode_tail and not teng.vae.layers[0].use_fused_ff
    cube, prior, want = _jax_chain()
    got = teng.sample_tokens(cube, prior)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    q = np.random.default_rng(9).uniform(-1, 1, size=(2, 3000, 3)).astype(np.float32)
    j_logits = np.asarray(jeng.vae.apply({"params": vparams}, jnp.asarray(want), jnp.asarray(q),
                                         method="decode"))[..., 0]
    t_logits = teng.decode_queries(want, q).numpy()
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=1e-4)


CHURN = {"s_churn": 40.0, "s_min": 0.05, "s_max": 50.0, "s_noise": 1.003}


def test_churn_chain_matches_jax_engine():
    """The engine's 35-NFE chain with churn (per-frame AdaLN rows from the
    churned sigma at every NFE) against JAX's ``_sample_impl``, JAX's prior
    and churn draws injected."""
    jeng, params, vparams = jax_engine_and_params(0)
    cube = np.random.default_rng(4).normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    seeds = jnp.arange(2)
    j2 = copy.copy(jeng)
    j2.sampler_kwargs = dict(jeng.sampler_kwargs, **CHURN)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(j2._sample_impl)(params, jnp.asarray(cube), seeds))
    inf = dict(TINY_CFG["eval"]["inference"], **CHURN)
    teng = torch_engine(params, vparams, eval={"inference": inf})
    teng.draw_churn = lambda sp, step, m, c, dev: torch.from_numpy(
        _jax_churn_eps([0, 1], step, (m, c)).copy())
    got = teng.sample_tokens(cube, np.asarray(jedm.sample_prior_latents(seeds, 16, 8)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    _, _, plain = _jax_chain()
    assert np.abs(plain - want).max() > 0.1  # churn changed the chain


def test_churn_engine_draws_are_per_frame():
    """With the port's own draws a frame's tokens do not depend on its
    batch; an injected prior without injected churn noise raises."""
    _, params, vparams = jax_engine_and_params(0)
    inf = dict(TINY_CFG["eval"]["inference"], num_steps=4, **CHURN)
    teng = torch_engine(params, vparams, eval={"inference": inf})
    cube = np.random.default_rng(4).normal(size=(3, 32, 16, 16, 3)).astype(np.float32)
    batch = teng.sample_tokens(cube, [7, 2, 9])
    alone = teng.sample_tokens(cube[1:2], [2])
    torch.testing.assert_close(alone[0], batch[1], rtol=0, atol=1e-5 * float(batch.abs().max()))
    plain = torch_engine(params, vparams, eval={"inference": dict(inf, s_churn=0.0)})
    assert (plain.sample_tokens(cube[1:2], [2]) - alone).abs().max() > 1e-2
    with pytest.raises(ValueError, match="no seeds to key"):
        teng.sample_tokens(cube[:1], np.zeros((1, 16, 8), np.float32))


def test_churn_static_int8_runs_the_dynamic_ff(tmp_path):
    """``int8_ff: "static"`` with churn takes no activation-scale rows (JAX
    :421-424): its chain is the dynamic int8 chain's, bitwise."""
    _, params, vparams = jax_engine_and_params(0)
    rng = np.random.default_rng(0)
    npz = tmp_path / "s.npz"
    np.savez(npz, ah=rng.uniform(3, 6, (4, 2)).astype(np.float32),
             ag=rng.uniform(1, 3, (4, 2)).astype(np.float32), num_steps=4)
    base = dict(TINY_CFG["eval"]["inference"], num_steps=4, **CHURN)
    static = torch_engine(params, vparams, eval={"inference": dict(
        base, int8_ff="static", int8_act_scales=str(npz))})
    dynamic = torch_engine(params, vparams, eval={"inference": dict(base, int8_ff=True)})
    cube = np.random.default_rng(4).normal(size=(1, 32, 16, 16, 3)).astype(np.float32)
    torch.testing.assert_close(static.sample_tokens(cube, [1]), dynamic.sample_tokens(cube, [1]),
                               rtol=0, atol=0)
