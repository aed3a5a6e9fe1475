"""The precision gate's port (``rald_torch.cli.precision_gate``) against
``scripts/precision_gate.py`` on the CPU, at depth 2 (the JAX test
harness's tiny generation config), with the same weights carried over by
``rald_torch/convert/flax_params.py`` (the VAE's query projection sharpened
10x and its occupancy bias centred on probe logits, as
``tests/test_torch_evaluate.py`` does, so that the masks are not all one
value), JAX's per-seed prior draw injected through
``GenerationEngine.draw_prior``, the same test-split batches (2 frames a
batch, 512 densified CFAR helper points a frame), seeds ``b*B ..`` and one
``default_rng(0)`` grid stream of 2048 queries a batch:

- the mask phase (``precision_gate.mask_hits``) agrees with JAX's mask
  loop (``scripts/precision_gate.py:99-122``) on at least 99.9 % of the
  queries at ``highest`` on both sides. The bar leaves room for thresholds
  within float32 rounding of 0 (ROADMAP C5 "Thresholds"), which flip
  between two correct f32 implementations; measured here: 100 %;
- ``precision_gate.run`` (both runs, the mask phase and ``evaluate`` with
  refine, on ``.pth`` files) writes an artifact with every key of JAX's
  (``docs/artifacts/precision_gate_checkpoint-479.json``) and the torch
  settings of each run. Started at torch's process defaults, the first two
  runs differ in ``cudnn_allow_tf32`` only, which the CPU ignores: agreement
  1.0 and zero deltas. The third, ``medium`` (``apply_matmul_precision(
  "default")``), records its settings, its mask agreement with ``highest``
  (at least 0.99) and its deltas (|ΔIoU| within the gate's 0.005 bar), and
  the process's settings are restored after the run."""
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.config import Config as TConfig
from torch_parity import jax_engine_and_params

REPO = Path(__file__).resolve().parent.parent
PARAM_SEED = 1
MASK_BATCHES = 2
GRID = 2048
AGREEMENT_BAR = 0.999


@pytest.fixture(autouse=True)
def _restore_precision():
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_tpu.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("gate_tree")
    return make_synthetic_coloradar(root, num_train_seqs=1, num_eval_seqs=1, frames_per_seq=3,
                                    points_per_frame=4000, radar_shape=(32, 16, 16), seed=1)


def _cfgs(root):
    """The JAX harness's eval config with JAX's recipe switches (host-densified
    helpers, refine) at tiny counts; the port's config is the same dict."""
    from test_generation import _gen_cfg

    j = _gen_cfg(root, "eval")
    j.dataset.query_helper_aug = True
    j.dataset.query_aug_num = 512
    j.dataset.eval_batch_size = 2
    j.eval.use_test_set = True
    j.eval.store_pc = False
    j.eval.freq = 1
    j.eval.inference.update({"num_query_points": GRID, "query_helper": True,
                             "refine_query": True, "refine_query_aug_num": 1024,
                             "refine_query_scale": 10})
    return j, TConfig(json.loads(json.dumps(j.to_dict())))


def _jax_prior(seeds, n_latents, channels, device):
    from rald_torch.diffusion.edm import sample_prior_latents as t_prior
    from rald_tpu.diffusion.edm import sample_prior_latents as j_prior

    return t_prior(np.asarray(j_prior(jnp.asarray(list(seeds)), n_latents, channels)),
                   n_latents, channels, device)


@pytest.fixture(scope="module")
def weights(tree):
    """JAX params and the port's state_dicts of the same weights."""
    from rald_torch.convert.flax_params import edm_state_dict_from_flax, vae_state_dict_from_flax
    from rald_torch.data.coloradar import ColoRadarDataset
    from rald_torch.train.gen_engine import GenerationEngine

    _, params, vparams = jax_engine_and_params(PARAM_SEED)
    vp = jax.tree_util.tree_map(lambda a: np.array(a), vparams)
    vp["dec_cross_attn"]["to_q"]["kernel"] *= 10.0
    edm_sd = edm_state_dict_from_flax(params, depth=2)
    _, tcfg = _cfgs(tree)
    eng = GenerationEngine(tcfg, device="cpu")
    eng.load_state_dicts(edm_sd, vae_state_dict_from_flax(vp, depth=2))
    item = ColoRadarDataset(tree, tcfg.dataset, loader_type="test")[0]
    probe = np.random.default_rng(1).uniform(-1, 1, size=(1, 4096, 3)).astype(np.float32)
    tokens = eng.sample_tokens(item["radar_cube"][None], [0])
    vp["to_outputs"]["bias"] -= np.float32(np.quantile(eng.decode_queries(tokens, probe), 0.5))
    return params, vp, edm_sd, vae_state_dict_from_flax(vp, depth=2)


def _jax_mask_hits(jcfg, params, vparams) -> np.ndarray:
    """``scripts/precision_gate.py``'s mask loop on the JAX engine."""
    from rald_tpu.cli.main_generation import build_loaders
    from rald_tpu.eval.queries import build_query_grid
    from rald_tpu.train.gen_engine import GenerationEngine

    engine = GenerationEngine(jcfg)
    _, eval_loader, _ = build_loaders(jcfg, {"world_size": 1, "rank": 0}, "eval")
    rng_np = np.random.default_rng(0)
    masks = []
    it = iter(eval_loader)
    for b in range(MASK_BATCHES):
        batch = next(it)
        grid = build_query_grid(jcfg.dataset.lidar, int(jcfg.eval.inference.num_query_points),
                                False, rng_np)
        bsz = np.asarray(batch["lidar_points"]).shape[0]
        helper = np.asarray(batch["helper_points"], np.float32)
        _, _, hits = engine._sample_and_decode(
            params, vparams, jax.device_put(batch["radar_cube"]),
            np.arange(b * bsz, (b + 1) * bsz), jax.device_put(batch["query_points"]),
            jax.device_put(grid), jax.device_put(helper))
        masks.append(np.asarray(hits))
    return np.concatenate(masks)


def test_mask_phase_agrees_with_jax_at_highest(tree, weights):
    from rald_torch.cli.main_generation import build_eval_loader
    from rald_torch.cli.precision_gate import mask_hits
    from rald_torch.train.gen_engine import GenerationEngine

    params, vp, edm_sd, vae_sd = weights
    jcfg, tcfg = _cfgs(tree)
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        want = _jax_mask_hits(jcfg, params, vp)
    eng = GenerationEngine(tcfg, device="cpu")
    eng.load_state_dicts(edm_sd, vae_sd)
    eng.draw_prior = _jax_prior
    got = mask_hits(eng, tcfg, build_eval_loader(tcfg, "eval", print_fn=lambda *a: None),
                    MASK_BATCHES)
    assert got.shape == want.shape == (MASK_BATCHES * 2, GRID + 512)
    assert 0.2 < want.mean() < 0.8  # both values occur
    agreement = float(np.mean(got == want))
    assert agreement >= AGREEMENT_BAR, agreement


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_run_writes_jaxs_keys_and_each_runs_settings(tree, weights, tmp_path):
    from rald_torch.cli import precision_gate
    from rald_torch.train.checkpoint import save_torch_checkpoint

    _, _, edm_sd, vae_sd = weights
    _, tcfg = _cfgs(tree)
    ckpt = save_torch_checkpoint(tmp_path / "out_gen" / "checkpoint-1.pth", edm_sd)
    tcfg.lidar_ae.ckpt = str(save_torch_checkpoint(tmp_path / "vae.pth", vae_sd))
    tcfg.eval.ckpt = str(ckpt)
    # torch as a process starts
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = True
    lines = []
    art = precision_gate.run(tmp_path, ckpt, 1, device="cpu", cfg=copy.deepcopy(tcfg),
                             print_fn=lines.append)
    path = tmp_path / "precision_gate_checkpoint-1.json"
    assert json.loads(path.read_text()) == art
    jax_art = json.loads((REPO / "docs" / "artifacts" / "precision_gate_checkpoint-479.json")
                         .read_text())
    assert _keys(jax_art) <= _keys(art)
    assert f"Loaded frozen VAE from {tcfg.lidar_ae.ckpt}" in lines
    d, h = art["precisions"]["default"], art["precisions"]["highest"]
    assert d["settings"]["cudnn_allow_tf32"] and not h["settings"]["cudnn_allow_tf32"]
    assert d["settings"]["float32_matmul_precision"] == h["settings"]["float32_matmul_precision"] \
        == "highest"
    assert not art["same_settings"]
    assert art["mask"]["queries_compared"] == 2 * (GRID + 512)
    assert art["mask"]["agreement"] == 1.0
    assert art["deltas_default_minus_highest"] == {"iou": 0.0, "cd_m": 0.0, "fscore": 0.0}
    assert all(np.isfinite(d[k]) and d[k] >= 0 for k in ("iou", "cd_m", "fscore"))
    # the third run, apply_matmul_precision("default"): torch's "medium"
    m = art["precisions"]["medium"]
    assert m["settings"]["float32_matmul_precision"] == "medium" and m["settings"]["cudnn_allow_tf32"]
    assert list(art["precisions"]) == ["default", "highest", "medium"]
    assert art["mask_medium_vs_highest"]["queries_compared"] == 2 * (GRID + 512)
    # the CPU may compute "medium" f32 matmuls in bf16 (measured here: agreement
    # 0.9957, delta IoU -0.00049); the gate's bar holds either way
    assert art["mask_medium_vs_highest"]["agreement"] >= 0.99
    assert abs(art["deltas_medium_minus_highest"]["iou"]) <= 0.005
    # the process's settings are restored
    assert torch.get_float32_matmul_precision() == "highest" and torch.backends.cudnn.allow_tf32
