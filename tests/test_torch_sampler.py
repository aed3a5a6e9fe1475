"""The churn-free EDM Heun sampler: the whole 18-step / 35-NFE chain of
rald_torch against rald_tpu's engine on the tiny model, fed the same prior
draw (JAX's per-seed stream, injected into the port as numpy): as the YAML
ships, with ``system.fast_inference: false`` (then also the unfolded
decode) and with ``ar_model.overrides: {use_fused_attn: true}``.

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


def test_churn_is_refused():
    with pytest.raises(NotImplementedError, match="churn"):
        tedm.edm_sampler(lambda x, s, i: x, torch.zeros(1, 2, 2), s_churn=1.0)


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
