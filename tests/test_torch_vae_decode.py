"""The VAE decode side: rald_torch's folded decode against rald_tpu's folded
decode (``fold_decode_tail=True``) and its unfolded decode, and the port's
unfolded decode against JAX's, on the tiny VAE with flax ``model.init``
weights carried across.

Float32 at the highest matmul precision: logits to 1e-4; the thresholded
occupancy masks agree on >= 99.9% of queries (scripts/full_parity.py's
bar: a logit within float32 rounding of the threshold may flip)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.convert.flax_params import vae_state_dict_from_flax
from rald_torch.models.registry import get_ae_model as t_get_ae
from rald_torch.ops.query_attention import map_query_chunks

OVERRIDES = dict(dim=64, queries_dim=64, depth=2, num_latents=16, latent_dim=8, heads=4,
                 dim_head=16)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def vaes():
    from rald_tpu.models.registry import get_ae_model as j_get_ae  # needs flax

    jvae = j_get_ae("kl_d512_m512_l32_mix", N=256).copy(**OVERRIDES)
    key = jax.random.PRNGKey(1)
    init = jax.jit(lambda k: jvae.init({"params": k, "latent": k}, jnp.zeros((1, 256, 3)),
                                       jnp.zeros((1, 8, 3))))
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), init(key)["params"])
    tvae = t_get_ae("kl_d512_m512_l32_mix", N=256, overrides=dict(OVERRIDES, query_chunk=4096),
                    fold_decode_tail=True)
    tvae.load_state_dict(vae_state_dict_from_flax(params, depth=2, query_type="mix"))
    return jvae, params, tvae.eval()


def _latents_and_queries(n_q=9000, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, 16, 8)).astype(np.float32)
    q = rng.uniform(-1, 1, size=(2, n_q, 3)).astype(np.float32)
    return z, q


def _centre(tvae, params, z, q):
    """Shift the occupancy bias to the median logit on both sides, so about
    half the queries fall on each side of the threshold."""
    with torch.no_grad():
        logits = tvae.decode(torch.from_numpy(z), torch.from_numpy(q)).squeeze(-1)
    shift = -float(logits.median())
    params = jax.tree_util.tree_map(lambda a: a, params)
    params["to_outputs"]["bias"] = params["to_outputs"]["bias"] + shift
    with torch.no_grad():
        tvae.to_outputs.bias += shift
    return params


def test_decode_latents(vaes):
    jvae, params, tvae = vaes
    z, _ = _latents_and_queries()
    want = jvae.apply({"params": params}, jnp.asarray(z), method="decode_latents")
    got = tvae.decode_latents(torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("jax_folded", [True, False])
def test_folded_decode_matches_jax(vaes, jax_folded):
    _decode_matches_jax(vaes, jax_folded, port_folded=True)


def test_unfolded_decode_matches_jax(vaes):
    """``fold_decode_tail`` off (``system.fast_inference: false`` in the
    engine): point-embed -> LayerNorm -> cross-attention -> head, streamed
    in chunks, against JAX's unfolded ``decode_queries``."""
    _, _, tvae = vaes
    tvae.set_flags(fold_decode_tail=False)
    try:
        _decode_matches_jax(vaes, jax_folded=False, port_folded=False)
    finally:
        tvae.set_flags(fold_decode_tail=True)


def _decode_matches_jax(vaes, jax_folded, port_folded):
    jvae, params, tvae = vaes
    assert tvae.fold_decode_tail == port_folded
    z, q = _latents_and_queries(seed=1)
    params = _centre(tvae, params, z, q[:, :2048])
    try:
        jmod = jvae.copy(fold_decode_tail=jax_folded, query_chunk=4096)
        want = np.asarray(jax.jit(lambda p, z, q: jmod.apply({"params": p}, z, q, method="decode"))(
            params, jnp.asarray(z), jnp.asarray(q)))[..., 0]
        with torch.no_grad():
            got = tvae.decode(torch.from_numpy(z), torch.from_numpy(q)).squeeze(-1).numpy()
    finally:
        with torch.no_grad():
            tvae.to_outputs.bias.copy_(torch.from_numpy(vaes[1]["to_outputs"]["bias"]))
    assert got.shape == (2, 9000)
    np.testing.assert_allclose(got, want, **TOL)
    assert 0.2 < (want > 0).mean() < 0.8  # the mask check is not vacuous
    assert ((got > 0) == (want > 0)).mean() >= 0.999


def test_decode_needs_one_output():
    """The folded decode folds a one-column occupancy head; with a wider
    head ``fold_decode_tail`` is ignored and the decode runs unfolded, as
    in JAX (``vecset_vae.py:229``)."""
    tvae = t_get_ae("kl_d512_m512_l32_mix", N=256, overrides=dict(OVERRIDES, output_dim=2),
                    fold_decode_tail=True).eval()  # no drop-path draws
    z, q = _latents_and_queries(n_q=64)
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z), torch.from_numpy(q))
        tvae.set_flags(fold_decode_tail=False)
        want = tvae.decode(torch.from_numpy(z), torch.from_numpy(q))
    assert got.shape == (2, 64, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_chunk_rule_matches_jax(vaes):
    jvae, _, tvae = vaes
    for bsz in (1, 2, 8, 32, 200):
        tvae.query_chunk = 65536
        assert tvae._chunk(bsz) == jvae._chunk(bsz)
    tvae.query_chunk = 4096


def test_map_query_chunks_ragged_tail():
    q = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10, 3)
    seen = []

    def fn(blk):
        seen.append(blk.shape[1])
        return blk.sum(-1, keepdim=True)

    out = map_query_chunks(fn, q, chunk_size=4)
    assert seen == [4, 4, 2]
    torch.testing.assert_close(out, q.sum(-1, keepdim=True))
