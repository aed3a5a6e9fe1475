"""The int8 drivers ``python -m rald_torch.cli.calibrate_int8`` and
``python -m rald_torch.cli.int8_gate`` on the CPU, with the JAX test
harness's tiny config over a synthetic tree and the tiny DiT's flax
weights as a reference ``.pth``:

- the static scales' default path: beside a ``.pth`` eval checkpoint
  (``<stem>.int8_act_scales.npz``), read by a static-mode engine given
  ``eval.ckpt`` alone (a directory keeps ``<dir>/int8_act_scales.npz``);
- the calibration CLI: its tables equal JAX's ``calibrate_act_scales`` on
  the same weights, batches and prior draws, on the dynamic-int8
  trajectory (JAX's Pallas kernels interpreted), to rtol 1e-4 (the bar of
  ``tests/test_torch_int8_dit.py``) over 4 steps and 1e-3 over 18; the
  margin is applied exactly; its defaults are 8 batches and 1.10;
- the gate CLI: its bf16 row is ``main_generation.run``'s stats, a
  ``--modes`` rerun keeps the settled rows, the static mode is skipped
  without an npz and runs with one."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import jax_engine_and_params


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_torch.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("int8_tree")
    make_synthetic_coloradar(root, num_train_seqs=1, num_eval_seqs=1, frames_per_seq=2,
                             points_per_frame=2000, radar_shape=(32, 16, 16), seed=1)
    return root


def _setup(tree, tmp_path, **updates):
    """The tiny eval YAML on the tree and the tiny DiT's weights (tree seed
    1 with parameter seed 1: every frame conditions to <= 1e-6) as a
    reference ``.pth``; returns (yaml path, ckpt path)."""
    from rald_torch.convert.flax_params import edm_state_dict_from_flax
    from rald_torch.train.checkpoint import save_torch_checkpoint
    from test_torch_main_generation import _cfg

    _, params, _ = jax_engine_and_params(1)
    ckpt = save_torch_checkpoint(tmp_path / "ckpt" / "checkpoint-7.pth",
                                 edm_state_dict_from_flax(params, depth=2))
    cfg = _cfg(tree, tmp_path, **updates)
    path = tmp_path / "gen.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(path), ckpt


def _jax_prior(seeds, n_latents, channels, device):
    from rald_tpu.diffusion.edm import sample_prior_latents

    return torch.from_numpy(np.array(sample_prior_latents(jnp.asarray(list(seeds)), n_latents,
                                                          channels))).to(device)


def test_static_scales_default_to_beside_the_pth(tmp_path):
    """The repaired default: ``eval.ckpt`` a ``.pth`` file -> the npz beside
    it, named after it (it used to be looked for inside the file's path as
    if it were a directory, which cannot exist)."""
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine, act_scales_path
    from torch_parity import TINY_CFG, tiny_cfg, torch_engine

    _, params, vparams = jax_engine_and_params(0)
    eng = torch_engine(params, vparams)
    cube = np.random.default_rng(4).normal(size=(1, 32, 16, 16, 3)).astype(np.float32)
    ah, ag = eng.calibrate_act_scales([{"radar_cube": cube}], num_batches=1, print_fn=lambda *_: None)
    ckpt = tmp_path / "checkpoint-479.pth"
    assert act_scales_path(ckpt) == tmp_path / "checkpoint-479.int8_act_scales.npz"
    assert act_scales_path(tmp_path) == tmp_path / "int8_act_scales.npz"
    np.savez(act_scales_path(ckpt), ah=ah, ag=ag, num_steps=18)
    inf = dict(TINY_CFG["eval"]["inference"], int8_ff="static")
    static = GenerationEngine(tiny_cfg(Config, eval={"inference": inf, "ckpt": str(ckpt)}),
                              device="cpu")
    table = static._act_scales.numpy()
    np.testing.assert_array_equal(table[..., 0], ah)
    np.testing.assert_array_equal(table[..., 1], ag)
    with pytest.raises(FileNotFoundError, match="checkpoint-9.int8_act_scales.npz"):
        GenerationEngine(tiny_cfg(Config, eval={"inference": inf,
                                                "ckpt": str(tmp_path / "checkpoint-9.pth")}),
                         device="cpu")


@pytest.mark.parametrize("num_steps,rtol", [(4, 1e-4), (18, 1e-3)])
def test_calibrate_cli_matches_jax(tree, tmp_path, monkeypatch, num_steps, rtol):
    """rtol: the calibration bar of tests/test_torch_int8_dit.py (1e-4) on a
    4-step chain. Over 18 steps the dynamic-int8 trajectories of the two
    sides part: an int8 code that sits on a .5 tie rounds by the f32 sum
    order before it, and the chain compounds that (the int8 chain's token
    bar there is 1e-2 of rms); the tables then agree to 2.6e-4 at worst, so
    the 18-step bar is 1e-3."""
    from jax.experimental.pallas import tpu as pltpu

    import rald_torch.train.gen_engine as ge
    from rald_torch.cli import calibrate_int8
    from rald_torch.cli.main_generation import build_eval_loader
    from rald_torch.config import load_config
    from rald_torch.train.gen_engine import GenerationEngine

    cfg_path, ckpt = _setup(tree, tmp_path)
    cfg = load_config(cfg_path)
    cfg.eval.inference.num_steps = num_steps
    monkeypatch.setattr(ge, "sample_prior_latents", _jax_prior)
    lines = []
    path = calibrate_int8.run(copy.deepcopy(cfg), ckpt, num_batches=2, margin=1.1, device="cpu",
                              print_fn=lines.append)
    assert path == tmp_path / "ckpt" / "checkpoint-7.int8_act_scales.npz"
    assert lines[-1] == f"written: {path}" and lines[-5].startswith("h amax: per-step min [")
    with np.load(path) as z:
        ah, ag, steps = z["ah"], z["ag"], int(z["num_steps"])
    assert ah.shape == ag.shape == (num_steps, 2) and steps == num_steps and (ah > 0).all()

    jeng, params, _ = jax_engine_and_params(1)
    j2 = copy.copy(jeng)
    j2.model_eval = jeng.model.copy(use_fused_ff=True, use_int8_ff=True)
    j2.sampler_kwargs = dict(jeng.sampler_kwargs, num_steps=num_steps)
    batches = list(build_eval_loader(copy.deepcopy(cfg), "eval"))[:2]
    assert len(batches) == 2
    with pltpu.force_tpu_interpret_mode():
        j_ah, j_ag = j2.calibrate_act_scales(params, batches, num_batches=2, margin=1.1,
                                             print_fn=lambda *_: None)
    np.testing.assert_allclose(ah, j_ah, rtol=rtol)
    np.testing.assert_allclose(ag, j_ag, rtol=rtol)

    # the margin exactly; the default path read back by a static engine
    out = tmp_path / "m1.npz"
    calibrate_int8.run(copy.deepcopy(cfg), ckpt, num_batches=2, margin=1.0, out=out,
                       device="cpu", print_fn=lambda *_: None)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["ah"] * 1.1, ah)
        np.testing.assert_array_equal(z["ag"] * 1.1, ag)
    cfg.eval.ckpt, cfg.eval.inference.int8_ff = str(ckpt), "static"
    np.testing.assert_array_equal(GenerationEngine(cfg, device="cpu")._act_scales[..., 0].numpy(), ah)


def test_calibrate_cli_defaults(tree, tmp_path):
    from rald_torch.cli import calibrate_int8

    cfg_path, ckpt = _setup(tree, tmp_path)
    seen = {}
    real = calibrate_int8.GenerationEngine.calibrate_act_scales

    def spy(self, batches, num_batches=2, margin=1.0, print_fn=print):
        seen.update(num_batches=num_batches, margin=margin)
        return real(self, batches, num_batches, margin, print_fn)

    calibrate_int8.GenerationEngine.calibrate_act_scales = spy
    try:
        path = calibrate_int8.main(["--config", cfg_path, "--ckpt", str(ckpt), "--device", "cpu",
                                    "--out", str(tmp_path / "d.npz")])
    finally:
        calibrate_int8.GenerationEngine.calibrate_act_scales = real
    assert seen == {"num_batches": 8, "margin": 1.10} and path == tmp_path / "d.npz"
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        calibrate_int8.main(["--config", cfg_path, "--ckpt", str(tmp_path / "x.pth"),
                             "--device", "cpu"])


def test_gate_cli_rows_partial_rerun_and_static(tree, tmp_path):
    from rald_torch.cli import calibrate_int8, int8_gate, main_generation
    from rald_torch.config import finalize_dirs, load_config

    cfg_path, ckpt = _setup(tree, tmp_path)
    lines = []
    art = int8_gate.main(["--config", cfg_path, "--ckpt", str(ckpt), "--device", "cpu",
                          "--modes", "bf16,int8_ff,int8_ff_static+attn_vout"])
    out = tmp_path / "out" / "exp" / "int8_gate_checkpoint-7.json"
    assert json.loads(out.read_text()) == art
    assert sorted(art["modes"]) == ["bf16", "int8_ff"]  # static skipped: no npz
    # the torch settings in force during the runs (the fixture's "highest"),
    # not a label; the YAML sets no matmul_precision
    assert art["device"] == "cpu" and art["system_matmul_precision"] is None
    assert art["matmul_precision"]["float32_matmul_precision"] == "highest"
    assert set(art["matmul_precision"]) == {"float32_matmul_precision", "cuda_matmul_allow_tf32",
                                            "cudnn_allow_tf32"}
    # the bf16 row is main_generation.run's stats on the same eval config
    cfg = load_config(cfg_path)
    cfg.system.mode, cfg.eval.ckpt, cfg.eval.store_pc = "eval", str(ckpt), False
    cfg.system.output_dir = str(tmp_path / "direct")
    stats = main_generation.run(cfg, device="cpu", print_fn=lines.append)
    assert art["modes"]["bf16"] == {"iou": round(stats["iou"], 4), "cd_m": round(stats["cd"], 4),
                                    "fscore": round(stats["fscore"], 4), "launches": {},
                                    "delta_iou_vs_bf16": 0.0}
    assert (tmp_path / "out" / "exp" / "int8_gate" / "int8_ff" / "config.yml").exists()

    # the static mode once the scales exist; the settled rows are kept
    calibrate_int8.run(load_config(cfg_path), ckpt, num_batches=1, device="cpu",
                       print_fn=lambda *_: None)
    lines.clear()
    cfg2 = finalize_dirs(load_config(cfg_path))
    cfg2.system.matmul_precision = "default"  # applied by main_generation.run: torch "medium"
    try:
        art2 = int8_gate.run(cfg2, ckpt, modes=["int8_ff_static+attn_vout"], device="cpu",
                             print_fn=lines.append)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = True
    assert art2["system_matmul_precision"] == "default"
    assert art2["matmul_precision"]["float32_matmul_precision"] == "medium"
    assert "=== mode int8_ff_static+attn_vout ===" in lines
    assert sorted(art2["modes"]) == ["bf16", "int8_ff", "int8_ff_static+attn_vout"]
    assert art2["modes"]["bf16"] == art["modes"]["bf16"]
    row = art2["modes"]["int8_ff_static+attn_vout"]
    assert row["delta_iou_vs_bf16"] == round(row["iou"] - art["modes"]["bf16"]["iou"], 4)
    with pytest.raises(ValueError, match="unknown mode"):
        int8_gate.run(load_config(cfg_path), ckpt, modes=["int4"], device="cpu")
