"""The slice as a whole: rald_torch's ``GenerationEngine.fused_eval_step``
against rald_tpu's ``_fused_eval_step_impl`` on the tiny YAML config with
the same weights, the same injected prior draw (JAX's per-seed stream), an
injected query grid and pre-densified helper points (refine off, so no RNG
stream is involved); and ``densify_queries`` by construction and
distribution, since torch's and JAX's random streams differ.

Tolerances: loss/IoU/accuracy to 1e-5 and n_pred exactly (both sides run
float32); CD/F to 1e-4 relative, because the JAX side's CPU Chamfer uses
the ``|a|^2+|b|^2-2ab`` scan (rald_tpu/eval/chamfer.py:54), which loses
~1e-5 of d^2 to cancellation at ~15 m coordinates, while the port is exact
subtract-square."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch import geometry as tgeo
from rald_torch.eval.densify import densify_queries as t_densify
from rald_tpu.diffusion.edm import sample_prior_latents
from rald_tpu.eval.densify import densify_queries as j_densify
from torch_parity import jax_engine_and_params, torch_engine

PC_RANGE = [0, -90, -20, 15.8, 90, 20]
VOXEL = [0.05, 0.25, 0.5]


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def engines():
    jeng, params, vparams = jax_engine_and_params(0)
    teng = torch_engine(params, vparams)
    return jeng, params, vparams, teng


def _batch(bsz=2, seed=0):
    rng = np.random.default_rng(seed)
    surface = rng.uniform(-1, 1, size=(bsz, 512, 3)).astype(np.float32)
    surface[..., 0] = np.clip(rng.normal(0.2, 0.1, size=(bsz, 512)), -1, 1)  # a shell
    return dict(
        radar_cube=rng.normal(size=(bsz, 32, 16, 16, 3)).astype(np.float32),
        q_eval=rng.uniform(-1, 1, size=(bsz, 512, 3)).astype(np.float32),
        labels=(rng.uniform(size=(bsz, 512)) < 0.3).astype(np.float32),
        grid=rng.uniform(-1, 1, size=(1024, 3)).astype(np.float32),
        helper=rng.uniform(-1, 1, size=(bsz, 256, 3)).astype(np.float32),
        surface=surface,
        surface_mask=np.arange(512)[None] < np.array([[512], [400]])[:bsz],
    )


def _centred_vae_params(params, vparams, teng, b):
    """VAE weights that give a real cloud on every frame, on both sides:
    random weights attend almost uniformly (every query gets about its
    frame's mean logit), so the decoder's query projection is sharpened
    10x; the occupancy bias then moves the threshold into the widest gap
    between the middle logits, so float32 summation order flips no query."""
    from rald_torch.convert.flax_params import vae_state_dict_from_flax

    vp = jax.tree_util.tree_map(lambda a: np.array(a), vparams)
    vp["dec_cross_attn"]["to_q"]["kernel"] *= 10.0
    teng.vae.load_state_dict(vae_state_dict_from_flax(vp, depth=2))
    seeds = jnp.arange(b["q_eval"].shape[0])
    prior = np.asarray(sample_prior_latents(seeds, 16, 8))
    tokens = teng.sample_tokens(b["radar_cube"], prior)
    grid = np.broadcast_to(b["grid"], (len(seeds),) + b["grid"].shape)
    q = np.concatenate([grid, b["helper"], b["q_eval"]], axis=1)
    logits = np.sort(teng.decode_queries(tokens, q).numpy().ravel())
    mid = logits[int(0.4 * len(logits)):int(0.6 * len(logits))]
    i = int(np.argmax(np.diff(mid)))
    vp["to_outputs"]["bias"] -= 0.5 * (mid[i] + mid[i + 1])
    teng.vae.load_state_dict(vae_state_dict_from_flax(vp, depth=2))
    return vp, prior


def _restore(teng, vparams):
    from rald_torch.convert.flax_params import vae_state_dict_from_flax

    teng.vae.load_state_dict(vae_state_dict_from_flax(vparams, depth=2))


def test_fused_eval_step_matches_jax(engines):
    jeng, params, vparams, teng = engines
    b = _batch()
    vp, prior = _centred_vae_params(params, vparams, teng, b)
    try:
        seeds = jnp.arange(2)
        qmask = np.ones_like(b["labels"])
        j_out = jeng._fused_eval(
            params, vp, jnp.asarray(b["radar_cube"]), seeds, jnp.asarray(b["q_eval"]),
            jnp.asarray(b["labels"]), jnp.asarray(qmask), jnp.asarray(b["grid"]),
            jax.random.PRNGKey(0), jnp.asarray(b["helper"]), None, jnp.asarray(b["surface"]),
            jnp.asarray(b["surface_mask"]), has_mask=False, compute_cd=True, refine=False,
            helper_aug=False, use_device_grid=False,
        )
        t_out = teng.fused_eval_step(
            b["radar_cube"], prior, b["q_eval"], b["labels"], qmask, b["grid"], None, b["helper"],
            None, b["surface"], b["surface_mask"], has_mask=False, compute_cd=True, refine=False,
            helper_aug=False, use_device_grid=False,
        )
        (j_loss, j_iou, j_acc, j_cd, j_f, j_n), (t_loss, t_iou, t_acc, t_cd, t_f, t_n) = (
            [np.asarray(v) for v in j_out], [v.numpy() for v in t_out])
        assert ((j_n > 100) & (j_n < 1180)).all()  # a real cloud on every frame
        np.testing.assert_array_equal(t_n, j_n)
        for t, j in ((t_loss, j_loss), (t_iou, j_iou), (t_acc, j_acc)):
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(t_cd, j_cd, rtol=1e-4)
        np.testing.assert_allclose(t_f, j_f, rtol=1e-4, atol=1e-6)
    finally:
        _restore(teng, vparams)


def test_full_recipe_runs_with_refine_and_device_grid(engines):
    """Device grid + on-device helper densify + refine + Chamfer: the product
    recipe's control flow at tiny size, with per-stage timings."""
    jeng, params, vparams, teng = engines
    b = _batch(seed=1)
    _centred_vae_params(params, vparams, teng, b)
    try:
        timings = {}
        gen = torch.Generator().manual_seed(0)
        hmask = np.arange(256)[None] < np.array([[200], [0]])  # frame 2: no CFAR points
        loss, iou, acc, cd, f, n = teng.fused_eval_step(
            b["radar_cube"], [0, 1], b["q_eval"], b["labels"], np.ones_like(b["labels"]), None,
            gen, b["helper"], hmask, b["surface"], b["surface_mask"], compute_cd=True,
            refine=True, helper_aug=True, use_device_grid=True, timings=timings,
        )
        assert set(timings) == {"cond", "sample", "decode", "refine", "chamfer"}
        assert n.shape == (2,) and (n > 0).all() and (n <= 512).all()  # refine_query_aug_num
        assert np.isfinite(cd.numpy()).all() and ((f >= 0) & (f <= 1)).all()
        assert np.isfinite(float(loss)) and 0 <= float(iou) <= 1 and 0 <= float(acc) <= 1
        neg = teng.fused_eval_step(
            b["radar_cube"], [0, 1], b["q_eval"], b["labels"], np.ones_like(b["labels"]), None,
            gen, None, None, b["surface"], b["surface_mask"], compute_cd=False, refine=False)
        assert (neg[3] == -1).all() and (neg[4] == -1).all()
    finally:
        _restore(teng, vparams)


def test_engine_reads_compute_dtype():
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine
    from torch_parity import tiny_cfg

    eng = GenerationEngine(tiny_cfg(Config, system={"compute_dtype": "bfloat16"}), device="cpu")
    assert eng.dtype == torch.bfloat16
    assert eng.model.model.proj_in.weight.dtype == torch.bfloat16
    assert eng.vae.to_outputs.weight.dtype == torch.bfloat16


def test_engine_refuses_unported_options():
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine
    from torch_parity import tiny_cfg

    with pytest.raises(ValueError, match="int8_ff must be bool or 'static'"):
        GenerationEngine(tiny_cfg(Config, eval={"inference": {"int8_ff": "dynamic"}}),
                         device="cpu")
    with pytest.raises(ValueError, match="int8_attn must be bool, 'full' or 'vout'"):
        GenerationEngine(tiny_cfg(Config, eval={"inference": {"int8_attn": "qk"}}), device="cpu")
    with pytest.raises(NotImplementedError, match="churn"):
        eng = GenerationEngine(tiny_cfg(Config, eval={"inference": {"s_churn": 1.0}}),
                               device="cpu")
        eng.sample_tokens(None, [0])


# ------------------------------------------------------------ densify_queries
def _norm(p):
    return tgeo.norm_points(p, PC_RANGE, True, False).astype(np.float32)


def _unnorm(p):
    return tgeo.inverse_norm_points(p, PC_RANGE, True, False)


def _t_densify(pts, mask, k, seed, scale=2):
    out, valid, n = t_densify(torch.from_numpy(pts), torch.from_numpy(mask), k,
                              torch.Generator().manual_seed(seed), PC_RANGE, VOXEL, scale,
                              True, False)
    return out.numpy(), valid.numpy(), n.numpy()


def test_densify_originals_verbatim_scattered_mask():
    rng = np.random.default_rng(0)
    pts = _norm(rng.uniform([0, -90, -20], [15.8, 90, 20], size=(2, 64, 3)))
    mask = rng.uniform(size=(2, 64)) > 0.6
    out, valid, n = _t_densify(pts, mask, 128, seed=0)
    for b in range(2):
        originals = pts[b][mask[b]]
        assert n[b] == len(originals)
        np.testing.assert_allclose(out[b, :n[b]], originals, atol=1e-6)
        assert valid[b].all()


def test_densify_fills_are_jittered_picks_in_bounds():
    rng = np.random.default_rng(1)
    pts = _norm(rng.uniform([0, -90, -20], [15.8, 90, 20], size=(1, 16, 3)))
    out, _, _ = _t_densify(pts, np.ones((1, 16), bool), 512, seed=1, scale=3)
    fills_un = _unnorm(out[0, 16:])
    lo, hi = np.asarray(PC_RANGE[:3]), np.asarray(PC_RANGE[3:])
    assert (fills_un >= lo - 1e-5).all() and (fills_un <= hi + 1e-5).all()
    d = np.abs(fills_un[:, None, :] - _unnorm(pts[0])[None, :, :])
    assert (d <= 3 * np.asarray(VOXEL) + 1e-5).all(axis=-1).any(axis=1).all()


def test_densify_zero_valid_and_more_than_k():
    pts = np.zeros((2, 8, 3), np.float32)
    mask = np.zeros((2, 8), bool)
    mask[1, 3] = True
    _, valid, n = _t_densify(pts, mask, 32, seed=2)
    assert n[0] == 0 and not valid[0].any()
    assert n[1] == 1 and valid[1].all()
    rng = np.random.default_rng(3)
    pts = _norm(rng.uniform([0, -90, -20], [15.8, 90, 20], size=(1, 64, 3)))
    out, _, _ = _t_densify(pts, np.ones((1, 64), bool), 16, seed=3)
    np.testing.assert_allclose(out[0], pts[0, :16], atol=1e-6)


def test_densify_fill_distribution_matches_jax():
    """Fills: which original is picked, and the jitter around it, follow the
    same distribution as the JAX function (different random streams)."""
    rng = np.random.default_rng(4)
    pts = _norm(rng.uniform([2, -60, -10], [12, 60, 10], size=(1, 8, 3)))
    k, n = 40000, 8
    t_out, _, _ = _t_densify(pts, np.ones((1, n), bool), k, seed=4, scale=3)
    j_out, _, _ = j_densify(pts, np.ones((1, n), bool), k, jax.random.PRNGKey(4), PC_RANGE, VOXEL,
                            3, True, False)
    orig = _unnorm(pts[0])
    stats = []
    for out in (t_out[0, n:], np.asarray(j_out)[0, n:]):
        fills = _unnorm(out)
        nearest = np.abs(fills[:, None, :] - orig[None]).sum(-1).argmin(1)
        picks = np.bincount(nearest, minlength=n) / len(fills)
        off = (fills - orig[nearest]) / np.asarray(VOXEL)  # U[-1,1) * U{1..3}
        stats.append((picks, np.abs(off).mean(0), off.std(0)))
    (tp, tm, ts), (jp, jm, js) = stats
    np.testing.assert_allclose(tp, 1 / n, atol=0.01)  # uniform picks
    np.testing.assert_allclose(jp, 1 / n, atol=0.01)
    np.testing.assert_allclose(tm, jm, rtol=0.03)  # E|offset| = 0.5 * E[scale] = 1.0
    np.testing.assert_allclose(ts, js, rtol=0.03)
    np.testing.assert_allclose(tm, 1.0, rtol=0.03)
