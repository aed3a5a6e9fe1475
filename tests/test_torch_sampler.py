"""The churn-free EDM Heun sampler: the whole 18-step / 35-NFE chain of
rald_torch against rald_tpu's engine on the tiny model, fed the same prior
draw (JAX's per-seed stream, injected into the port as numpy).

Float32 on both sides; 35 NFEs compound summation-order differences, and
the tokens end O(1)-O(10): 1e-3 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.diffusion import edm as tedm
from rald_tpu.diffusion import edm as jedm
from torch_parity import jax_engine_and_params, torch_engine


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


def test_full_35_nfe_chain_matches_jax():
    jeng, params, vparams = jax_engine_and_params(0)
    teng = torch_engine(params, vparams)
    cube = np.random.default_rng(4).normal(size=(2, 32, 16, 16, 3)).astype(np.float32)
    seeds = jnp.arange(2)
    prior = np.asarray(jedm.sample_prior_latents(seeds, 16, 8))
    want = np.asarray(jeng._sample(params, jnp.asarray(cube), seeds))
    got = teng.sample_tokens(cube, prior)
    assert got.shape == want.shape == (2, 16, 8)
    assert np.abs(want).max() > 1.0  # the chain did real work
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
