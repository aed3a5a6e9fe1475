"""The dataset eval loop: rald_torch's ``GenerationEngine.evaluate`` against
rald_tpu's ``evaluate`` on a synthetic ColoRadar tree, with the same weights
(carried over through ``rald_torch/convert/flax_params.py``), JAX's per-seed
prior draw injected through ``GenerationEngine.draw_prior``, float32 and
``matmul_precision: highest`` on both sides.

- The modular path (``store_pc: true``: host grid, host helper densify,
  host refine from one numpy stream) reproduces JAX's stats and PLY files.
- The fused path with a host grid (``use_cart_query``), host-densified
  helpers and no refine, where no device RNG is drawn, reproduces them too;
  with the device RNG (torch's stream differs from JAX's) loss / IoU /
  accuracy, which draw nothing, agree to the same tolerance and Chamfer / F
  by distribution.
- ``iou_test_only``, ``skip_eval_metric``, ``test_sample_speed``,
  ``store_latent`` and ``use_pred_latent`` (the latents ``store_latent``
  wrote), as cases of one test.
- The frozen radar encoder: ``encode_radar`` against JAX's
  ``_radar_encode``, and one frozen-config ``evaluate``.

Tolerances: loss / IoU / accuracy 1e-5; CD and F 1e-4 relative; PLY point
counts exactly and coordinates within 1e-5. JAX's CPU Chamfer uses the
``|a|^2+|b|^2-2ab`` form, whose cancellation at ~15 m coordinates moves CD
by ~4e-4 and flips F-score thresholds here, so the JAX side runs its TPU
branch instead, in the host batch API and in the fused step alike: the
Pallas ``nn_min_sq_both`` kernel (exact subtract-square) in interpret
mode. The
test tree and the weights' seed are chosen so that the tiny radar encoder
conditions every frame to <= 1e-6 on both sides (ROADMAP C5)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.config import Config as TConfig
from torch_parity import DRAW_SEED, draw_params, jax_engine_and_params
from torch_parity import jax_exact_chamfer as _jax_exact_chamfer

PARAM_SEED = 1  # jax_engine_and_params(1): every frame of the tree conditions to <= 1e-6
TREE_SEED = 1
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _highest_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_tpu.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("eval_tree")
    return make_synthetic_coloradar(root, num_train_seqs=1, num_eval_seqs=1, frames_per_seq=3,
                                    points_per_frame=4000, radar_shape=(32, 16, 16),
                                    seed=TREE_SEED)


def _cfgs(root, out, **eval_updates):
    """The JAX test harness's eval config (``tests/test_generation.py``) with
    raw per-frame clouds (``sampling: false``), raw CFAR helpers for the
    engine to densify (512 a frame, to 1024, so the densify draws from the
    host stream) and batches of 2 over 3 frames (pad-last): the same config
    for both packages, dumps in per-package directories."""
    from test_generation import _gen_cfg

    j = _gen_cfg(root, "eval")
    j.dataset.lidar.sampling = False
    j.dataset.lidar.pc_range_cart = [0, -15, -5, 15, 15, 5]
    j.dataset.query_helper_aug = True
    j.dataset.helper_aug_on_device = True
    j.dataset.query_aug_num = 1024  # > the 512 raw CFAR points: densifying draws
    j.dataset.eval_batch_size = 2
    j.system.output_dir = str(out / "out")
    for k, v in eval_updates.items():
        if k.startswith("dataset."):
            j.dataset[k.split(".", 1)[1]] = v
        elif k.startswith("inference."):
            j.eval.inference[k.split(".", 1)[1]] = v
        else:
            j.eval[k] = v
    t = TConfig(json.loads(json.dumps(j.to_dict())))
    j.eval.store_base_dir = str(out / "jax_dumps")
    t.eval.store_base_dir = str(out / "port_dumps")
    return j, t


def _jax_prior(seeds, n_latents, channels, device):
    from rald_torch.diffusion.edm import sample_prior_latents as t_prior
    from rald_tpu.diffusion.edm import sample_prior_latents as j_prior

    if isinstance(seeds, (np.ndarray, torch.Tensor)):
        return t_prior(seeds, n_latents, channels, device)
    return t_prior(np.asarray(j_prior(jnp.asarray(list(seeds)), n_latents, channels)),
                   n_latents, channels, device)


def _port_engine(cfg, edm_sd, vae_sd, radar_sd=None):
    from rald_torch.train.gen_engine import GenerationEngine

    eng = GenerationEngine(cfg, device="cpu")
    eng.load_state_dicts(edm_sd, vae_sd, radar_sd)
    eng.draw_prior = _jax_prior
    return eng


@pytest.fixture(scope="module")
def weights(tree):
    """JAX params and the port's state_dicts of the same weights; the VAE's
    query projection sharpened 10x and its occupancy bias set at the 75th
    percentile of probe logits, so every frame has a real, partial cloud."""
    from rald_torch.convert.flax_params import edm_state_dict_from_flax, vae_state_dict_from_flax
    from rald_torch.data.coloradar import ColoRadarDataset

    _, params, vparams = jax_engine_and_params(PARAM_SEED)
    vp = jax.tree_util.tree_map(lambda a: np.array(a), vparams)
    vp["dec_cross_attn"]["to_q"]["kernel"] *= 10.0
    edm_sd = edm_state_dict_from_flax(params, depth=2)
    _, tcfg = _cfgs(tree, tree)
    eng = _port_engine(tcfg, edm_sd, vae_state_dict_from_flax(vp, depth=2))
    item = ColoRadarDataset(tree, tcfg.dataset, loader_type="test")[0]
    probe = np.random.default_rng(1).uniform(-1, 1, size=(1, 4096, 3)).astype(np.float32)
    tokens = eng.sample_tokens(item["radar_cube"][None], [0])
    vp["to_outputs"]["bias"] -= np.float32(np.quantile(eng.decode_queries(tokens, probe), 0.75))
    return params, vp, edm_sd, vae_state_dict_from_flax(vp, depth=2)


def _jax_eval(jcfg, params, vparams, radar_params=None):
    from rald_tpu.cli.main_generation import build_loaders
    from rald_tpu.train.gen_engine import GenerationEngine

    eng = GenerationEngine(jcfg)
    eng._chamfer_pallas = True  # the fused step's Chamfer on its TPU branch too
    _, loader, _ = build_loaders(jcfg, {"world_size": 1, "rank": 0}, "eval")
    with _jax_exact_chamfer():
        return eng.evaluate(params, loader, vparams, radar_params, print_fn=lambda *_: None)


def _port_eval(tcfg, weights_or_engine):
    from rald_torch.cli.main_generation import build_eval_loader

    eng = weights_or_engine
    if isinstance(eng, tuple):
        eng = _port_engine(tcfg, *eng)
    loader = build_eval_loader(tcfg, "eval")
    return eng.evaluate(loader, print_fn=lambda *_: None)


def _assert_stats(got, want, cd=True):
    assert sorted(got) == sorted(want)
    for k in ("loss", "iou", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    if cd:
        np.testing.assert_allclose(got["cd"], want["cd"], rtol=1e-4, err_msg="cd")
        np.testing.assert_allclose(got["fscore"], want["fscore"], rtol=1e-4, atol=1e-6,
                                   err_msg="fscore")


@pytest.fixture(scope="module")
def modular(tree, weights, tmp_path_factory):
    """One modular (store_pc) evaluate on each side."""
    out = tmp_path_factory.mktemp("modular")
    jcfg, tcfg = _cfgs(tree, out)
    params, vp, edm_sd, vae_sd = weights
    return out, tcfg, _jax_eval(jcfg, params, vp), _port_eval(tcfg, (edm_sd, vae_sd))


def test_modular_evaluate_matches_jax(modular):
    from rald_torch.eval.ply import read_ply

    out, tcfg, want, got = modular
    _assert_stats(got, want)
    assert 0.05 < got["iou"] < 0.95 and np.isfinite(got["cd"])
    j_files = sorted(p.relative_to(out / "jax_dumps") for p in (out / "jax_dumps").rglob("*.ply"))
    t_files = sorted(p.relative_to(out / "port_dumps") for p in (out / "port_dumps").rglob("*.ply"))
    # <store_base_dir>/<exp_name>/<seq>/<save_pc_dir_name>/<frame>.ply, one per frame
    assert [str(p) for p in t_files] == [f"test_exp/synth_seq_2/pred_pc/{i:04d}.ply"
                                         for i in range(3)]
    assert t_files == j_files
    for f in t_files:
        t, j = read_ply(out / "port_dumps" / f), read_ply(out / "jax_dumps" / f)
        assert t.shape == j.shape and 0 < len(t) <= 512, f  # refine_query_aug_num 512
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=str(f))


def test_fused_evaluate_matches_jax(tree, weights, tmp_path):
    """The one-step path where it draws nothing on the device: a cartesian
    host grid, helpers densified by the dataset, no refine."""
    jcfg, tcfg = _cfgs(tree, tmp_path, store_pc=False, use_cart_query=True,
                       **{"dataset.helper_aug_on_device": False, "inference.refine_query": False})
    params, vp, edm_sd, vae_sd = weights
    got = _port_eval(tcfg, (edm_sd, vae_sd))
    _assert_stats(got, _jax_eval(jcfg, params, vp))
    assert not (tmp_path / "port_dumps").exists()


def test_fused_evaluate_device_rng_by_distribution(tree, weights, modular, tmp_path):
    """The product recipe's fused path: device grid, device helper densify,
    refine. Loss / IoU / accuracy draw nothing and agree with JAX's; Chamfer
    and F come from torch's stream, and agree with JAX's (its own stream)
    as two draws of the same distribution: 4096 grid queries a frame."""
    upd = {"store_pc": False, "inference.num_query_points": 4096,
           "inference.refine_query_aug_num": 2048}
    jcfg, tcfg = _cfgs(tree, tmp_path, **upd)
    params, vp, edm_sd, vae_sd = weights
    got, want = _port_eval(tcfg, (edm_sd, vae_sd)), _jax_eval(jcfg, params, vp)
    _assert_stats(got, want, cd=False)
    _assert_stats(got, modular[2], cd=False)  # same eval queries as the modular run
    np.testing.assert_allclose(got["cd"], want["cd"], rtol=0.05)
    np.testing.assert_allclose(got["fscore"], want["fscore"], rtol=0.1, atol=0.01)
    again = _port_eval(tcfg, (edm_sd, vae_sd))
    assert again == got  # one torch.Generator per batch, seeded from (seed, batch)


@pytest.mark.parametrize("mode", ["iou_test_only", "skip_eval_metric", "test_sample_speed",
                                  "store_latent", "use_pred_latent"])
def test_eval_modes(tree, weights, modular, tmp_path, mode):
    """Each eval mode against the modular run (JAX-checked above) or JAX's
    own pieces: ``iou_test_only`` scores the decoded surface with its mask
    (JAX ``_decode`` + ``_eval_metrics``); ``skip_eval_metric`` keeps the
    clouds and drops CD / F; ``test_sample_speed`` samples and scores
    nothing; ``store_latent`` writes each frame's tokens; and
    ``use_pred_latent`` decodes those latents with the rest of the modular
    path (JAX ``evaluate`` on the same files)."""
    from rald_torch.eval.ply import read_ply

    params, vp, edm_sd, vae_sd = weights
    out, _, want, _ = modular
    latents = tmp_path / "latents"
    upd = {mode: True}
    if mode == "store_latent":
        upd["store_pc"] = False
    if mode == "use_pred_latent":
        upd["dataset.use_pred_latent"] = True
        upd["dataset.pred_latent_base_dir"] = str(latents)
        upd["dataset.pred_latent_sub_dir"] = "test_exp"
        _, scfg = _cfgs(tree, tmp_path, store_pc=False, store_latent=True)
        scfg.eval.store_base_dir = str(latents)
        _port_eval(scfg, (edm_sd, vae_sd))
    jcfg, tcfg = _cfgs(tree, tmp_path, **upd)
    if mode == "store_latent":
        tcfg.eval.store_base_dir = str(latents)
    eng = _port_engine(tcfg, edm_sd, vae_sd)
    draws = []
    draw = eng.draw_prior
    eng.draw_prior = lambda *a: draws.append(list(a[0])) or draw(*a)
    got = _port_eval(tcfg, eng)
    if mode == "test_sample_speed":
        assert got == {"loss": -1.0, "iou": -1.0} and draws == [[0, 1], [2, 3]]
    elif mode == "iou_test_only":
        from rald_torch.cli.main_generation import build_eval_loader
        from rald_tpu.train.gen_engine import GenerationEngine

        jeng = GenerationEngine(jcfg)
        loader = build_eval_loader(tcfg, "eval")
        loss = []
        for it, b in enumerate(loader):
            tokens = jnp.asarray(eng.sample_tokens(b["radar_cube"], [2 * it, 2 * it + 1]).numpy())
            logits = jeng._decode(vp, tokens, jnp.asarray(b["lidar_points"]))
            loss.append([float(v) for v in jeng._eval_metrics(
                logits, jnp.asarray(b["query_labels"]), jnp.asarray(b["lidar_mask"]))])
        assert sorted(got) == ["accuracy", "iou", "loss"]
        np.testing.assert_allclose([got["loss"], got["iou"], got["accuracy"]],
                                   np.mean(loss, axis=0), **TOL)
    elif mode == "skip_eval_metric":
        _assert_stats({**got, "cd": want["cd"], "fscore": want["fscore"]}, want)
        assert got["cd"] == got["fscore"] == -1.0
        for f in (out / "port_dumps").rglob("*.ply"):
            np.testing.assert_array_equal(
                read_ply(tmp_path / "port_dumps" / f.relative_to(out / "port_dumps")), read_ply(f))
    elif mode == "store_latent":
        _assert_stats(got, want)
        files = sorted((latents / "test_exp" / "synth_seq_2" / "latent_tokens").glob("*.npy"))
        assert [f.name for f in files] == ["0000.npy", "0001.npy", "0002.npy"]
        from rald_torch.data.coloradar import ColoRadarDataset

        ds = ColoRadarDataset(tree, tcfg.dataset, loader_type="test")
        tok = eng.sample_tokens(np.stack([ds[0]["radar_cube"], ds[1]["radar_cube"]]), [0, 1])
        np.testing.assert_array_equal(np.load(files[1]), tok[1].numpy())
    else:  # use_pred_latent
        assert draws == []
        _assert_stats(got, _jax_eval(jcfg, params, vp))


# ---------------------------------------------------------------- frozen encoder
FROZEN_ENC = {"name": "ae_ch16_mult5_n2_d16", "ckpt": None, "overrides": {"embed_dim": 4}}


def _frozen_cfgs(root, out):
    j, t = _cfgs(root, out)
    for c in (j, t):
        c.ar_model.configs.unfreeze_radar_enc = False
        c.radar_enc = FROZEN_ENC
    return j, t


@pytest.fixture(scope="module")
def frozen(tree, weights):
    """The frozen-encoder engines' weights: the DiT without its in-graph
    encoder, a radar autoencoder (16 base channels, 4 latent channels),
    the VAE of the other tests."""
    from rald_torch.convert.flax_params import (
        edm_state_dict_from_flax,
        radar_encoder_state_dict_from_flax,
    )
    from rald_tpu.train.gen_engine import GenerationEngine

    jcfg, _ = _frozen_cfgs(tree, tree)
    eng = GenerationEngine(jcfg)
    m = eng.model
    rng = np.random.default_rng(DRAW_SEED + 10)
    params = draw_params(jax.eval_shape(
        m.init, jax.random.PRNGKey(0), jnp.zeros((1, m.n_latents, m.channels)), jnp.ones((1,)),
        jnp.zeros((1, 2, 1, 1, 4)))["params"], rng)
    enc = draw_params(jax.eval_shape(eng.init_radar_enc_params, jax.random.PRNGKey(2)), rng)
    return (eng, params, enc, weights[1], edm_state_dict_from_flax(params, depth=2), weights[3],
            radar_encoder_state_dict_from_flax(enc["encoder"], prefix="encoder."))


def test_encode_radar_matches_jax(tree, frozen):
    """``encode_radar`` (upsample off here, intensity channel) against JAX's
    ``_radar_encode`` on the tree's cubes, and the tokens it conditions."""
    from rald_torch.data.coloradar import ColoRadarDataset

    jeng, params, enc, _, edm_sd, vae_sd, enc_sd = frozen
    _, tcfg = _frozen_cfgs(tree, tree)
    eng = _port_engine(tcfg, edm_sd, vae_sd, enc_sd)
    assert type(eng.radar_enc).__name__ == "RadarAutoencoder"
    ds = ColoRadarDataset(tree, tcfg.dataset, loader_type="test")
    cube = np.stack([ds[i]["radar_cube"] for i in range(3)])
    got = eng.encode_radar(cube)
    want = np.asarray(jeng._radar_encode(enc, jnp.asarray(cube)))
    assert got.shape == want.shape == (3, 2, 1, 1, 4)
    # the encoder ends in a GroupNorm over 2 channels x 2 positions, which
    # turns f32 summation-order noise into ~1e-5 of max|z|
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(
        eng.sample_tokens(got, [0, 1, 2]).numpy(),
        np.asarray(jeng._sample(params, jnp.asarray(got.numpy()), jnp.arange(3))), atol=1e-4)


def test_frozen_config_evaluate_matches_jax(tree, frozen, tmp_path):
    """One frozen-encoder ``evaluate`` (modular path, PLY files) on each side."""
    from rald_torch.eval.ply import read_ply

    _, params, enc, vp, edm_sd, vae_sd, enc_sd = frozen
    jcfg, tcfg = _frozen_cfgs(tree, tmp_path)
    got = _port_eval(tcfg, (edm_sd, vae_sd, enc_sd))
    want = _jax_eval(jcfg, params, vp, enc)
    _assert_stats(got, want)
    files = sorted((tmp_path / "jax_dumps").rglob("*.ply"))
    assert len(files) == 3
    for f in files:
        t = read_ply(tmp_path / "port_dumps" / f.relative_to(tmp_path / "jax_dumps"))
        np.testing.assert_allclose(t, read_ply(f), atol=1e-5, rtol=0)

