"""The port's VAE encode against ``rald_tpu``'s, on the CPU in float32 with
``matmul_precision: highest``:

- farthest point sampling: indices equal to JAX's (random clouds with a
  duplicated point, per-batch start indices, and a regular grid full of
  distance ties);
- ``VecSetVAE.encode`` for ``mix`` (the product), ``learnable``, ``point``
  (FPS queries) and a deterministic-latent autoencoder, from the same
  parameters (drawn in ``model.init``'s tree, carried over by
  ``vae_state_dict_from_flax``) with JAX's posterior noise injected: KL,
  mean and z within 1e-5 of their max |value|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params

from rald_torch.ops.fps import farthest_point_sampling

VAE_OVERRIDES = {"dim": 64, "queries_dim": 64, "depth": 2, "num_latents": 16, "latent_dim": 8,
                 "heads": 4, "dim_head": 16}
N = 512


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("case", ["random", "grid"])
def test_fps_indices_match_jax(case):
    from rald_tpu.ops.fps import farthest_point_sampling as jax_fps

    rng = np.random.default_rng(5)
    if case == "random":
        pts = rng.standard_normal((3, 700, 3)).astype(np.float32)
        pts[1, 40] = pts[1, 41]
        start = np.array([0, 9, 311])
    else:
        g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = (g[None] * 0.1).astype(np.float32)
        start = np.array([3])
    want = np.asarray(jax_fps(jnp.asarray(pts), 96, jnp.asarray(start)))
    got = farthest_point_sampling(torch.from_numpy(pts), 96, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)
    single = farthest_point_sampling(torch.from_numpy(pts[0]), 96, int(start[0])).numpy()
    np.testing.assert_array_equal(single, want[0])


@pytest.mark.parametrize("name", ["kl_d512_m512_l32_mix", "kl_d512_m512_l32_learn",
                                  "kl_d512_m512_l32", "ae_d512_m64"])
def test_encode_matches_jax(name):
    from rald_tpu.models.registry import get_ae_model as jax_ae

    from rald_torch.convert.flax_params import vae_state_dict_from_flax
    from rald_torch.models.registry import AE_VARIANTS, get_ae_model

    overrides = dict(VAE_OVERRIDES)
    jm = jax_ae(name, N=N).copy(**overrides)
    rng = np.random.default_rng(11)
    pc = rng.uniform(-1, 1, (2, N, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0),
                                      "latent": jax.random.PRNGKey(1)},
                            jnp.zeros((1, N, 3)), jnp.zeros((1, 8, 3)))["params"]
    params = draw_params(shapes, rng)
    key = jax.random.PRNGKey(7)

    def enc(p, x):
        kl, z = jm.apply({"params": p}, x, rng=key, method="encode")
        return kl, z, jm.apply({"params": p}, x, sample_posterior=False, method="encode")[1]

    kl_j, z_j, mean_j = jax.jit(enc)(params, pc)

    tm = get_ae_model(name, N=N, overrides=overrides)
    qt = AE_VARIANTS[name].get("query_type", "point")
    tm.load_state_dict(vae_state_dict_from_flax(params, depth=2, query_type=qt))
    tm.eval().requires_grad_(False)  # JAX's deterministic default: no drop-path draws
    x = torch.from_numpy(pc)
    deterministic = AE_VARIANTS[name].get("deterministic", False)
    eps = None if deterministic else torch.from_numpy(
        np.array(jax.random.normal(key, np.asarray(mean_j).shape)))
    kl_t, z_t = tm.encode(x, eps=eps)
    _, mean_t = tm.encode(x, sample_posterior=False)
    for got, want in ((kl_t, kl_j), (z_t, z_j), (mean_t, mean_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(float(np.abs(want).max()), 1e-6))
    if not deterministic:
        assert float(np.abs(np.asarray(z_j) - np.asarray(mean_j)).max()) > 1e-3  # eps applied
