"""The port's stage-1 entry point ``python -m rald_torch.cli.main_ae`` on the
CPU against ``rald_tpu.cli.main_ae.run``, with a tiny VAE (depth 2, dim
64) over one synthetic ColoRadar tree (two train sequences of 4 frames,
one val sequence of 4; 128 LiDAR points a frame, 256 grid queries):

- train mode, 3 epochs, ``save_ckpt_freq`` 2, ``eval_freq`` 3: both write
  ``config.yml``, one ``log.txt`` record an epoch with the same keys
  (``train_*``, ``val_*`` after the last epoch, ``epoch``) and a checkpoint
  after epochs 1 and 2 (JAX's an orbax directory, the port's a ``.pth``
  file). JAX feeds ``batch_size`` x its 8 CPU devices a step, the port
  ``batch_size``, so only the files are compared, not the numbers;
- the port's loss falls over the 3 epochs;
- ``train.resume`` from ``checkpoint-1.pth`` trains epoch 2 only and ends
  bitwise equal to the uninterrupted run (checkpoint and log record);
- eval mode reads ``eval.ckpt`` (``model_ema`` with ``train.use_ema``): the
  same stats as the training run's last evaluation, or as an evaluation
  of the file's EMA;
- a dict-valued ``split_file`` runs eval once per scene, each into its own
  output directory;
- an orbax checkpoint directory (the JAX run's) as ``eval.ckpt`` raises,
  and so does ``WORLD_SIZE`` > 1."""
import copy
import json

import numpy as np
import pytest
import torch
import yaml

EPOCHS = 3
TRAIN_STEPS = 8  # train frames / batch 1


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_torch.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("ae_tree")
    make_synthetic_coloradar(root, num_train_seqs=2, num_eval_seqs=1, frames_per_seq=4,
                             points_per_frame=1500, seed=4)
    return root


def _cfg_dict(root, out, **updates) -> dict:
    from rald_torch.data.synthetic import synthetic_dataset_config

    ds = synthetic_dataset_config(root).to_dict()
    ds["lidar"]["num_samples"] = 128
    ds["radar"]["upsample"] = False
    ds.update(batch_size=1, num_workers=2)
    d = {
        "system": {"seed": 0, "mode": "train", "output_dir": str(out), "log_dir": None,
                   "compute_dtype": "float32"},
        "dataset": ds,
        "train": {"epochs": EPOCHS, "warmup_epochs": 0, "blr": 1e-3, "lr": 1e-3, "min_lr": 1e-6,
                  "clip_grad": 10, "accum_iter": 1, "vol_weight": 0.1, "near_weight": 1.0,
                  "save_ckpt_freq": 2, "eval_freq": 3, "use_ema": False},
        "lidar_ae": {"name": "kl_d512_m512_l32_mix",
                     "overrides": {"dim": 64, "queries_dim": 64, "depth": 2, "num_latents": 16,
                                   "latent_dim": 8, "heads": 4, "dim_head": 16}},
        "eval": {"inference": {"num_query_points": 256}, "freq": 1},
    }
    for k, v in updates.items():
        section, key = k.split(".", 1)
        d[section][key] = v
    return copy.deepcopy(d)


def _main(tmp, d, name="run.yml"):
    """``main_ae.main`` on a YAML of ``d`` on the CPU."""
    from rald_torch.cli import main_ae

    path = tmp / name
    path.write_text(yaml.safe_dump(d))
    return main_ae.main(["--config", str(path), "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    stats = _main(tmp, _cfg_dict(tree, tmp / "out"))[None]
    return tmp / "out", stats


@pytest.fixture(scope="module")
def jax_trained(tree, tmp_path_factory):
    from rald_tpu.cli.main_ae import run
    from rald_tpu.config import Config

    out = tmp_path_factory.mktemp("jax") / "out"
    run(Config(_cfg_dict(tree, out)))
    return out


def _records(out):
    return [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_train_mode_writes_jax_files(trained, jax_trained):
    out, stats = trained
    assert (out / "config.yml").exists() and (jax_trained / "config.yml").exists()
    assert yaml.safe_load((out / "config.yml").read_text())["train"]["epochs"] == EPOCHS
    mine, theirs = _records(out), _records(jax_trained)
    assert [r["epoch"] for r in mine] == [r["epoch"] for r in theirs] == list(range(EPOCHS))
    for a, b in zip(mine, theirs):
        assert sorted(a) == sorted(b)
    assert {"val_iou", "val_loss", "val_cd", "val_fscore", "train_grad_norm", "train_lr",
            "train_loss_kl"} <= set(mine[-1])
    assert sorted(p.name for p in out.glob("checkpoint-*")) == ["checkpoint-1.pth",
                                                                "checkpoint-2.pth"]
    assert sorted(p.name for p in jax_trained.glob("checkpoint-*")) == ["checkpoint-1",
                                                                        "checkpoint-2"]
    assert stats == {k[4:]: v for k, v in mine[-1].items() if k.startswith("val_")}


def test_loss_falls_and_checkpoints_hold_the_state(trained):
    out, _ = trained
    losses = [r["train_loss"] for r in _records(out)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    ck = _load(out / "checkpoint-2.pth")
    assert sorted(ck) == ["epoch", "model", "model_ema", "optimizer", "step"]
    assert ck["epoch"] == 2 and ck["step"] == EPOCHS * TRAIN_STEPS
    assert ck["optimizer"]["count"] == EPOCHS * TRAIN_STEPS
    assert sorted(ck["model"]) == sorted(ck["model_ema"])
    assert any(not torch.equal(ck["model"][k], ck["model_ema"][k]) for k in ck["model"])


def test_resume_trains_the_remaining_epochs(tree, trained, tmp_path):
    from rald_torch.cli import main_ae
    from rald_torch.config import Config

    out, _ = trained
    lines = []
    d = _cfg_dict(tree, tmp_path / "resumed", **{"train.resume": str(out / "checkpoint-1.pth")})
    main_ae.run(Config(d), device="cpu", print_fn=lines.append)
    assert "resumed from epoch 1" in lines
    rec = _records(tmp_path / "resumed")
    assert [r["epoch"] for r in rec] == [2]
    assert rec[0] == _records(out)[-1]
    assert [p.name for p in (tmp_path / "resumed").glob("checkpoint-*")] == ["checkpoint-2.pth"]
    a, b = _load(out / "checkpoint-2.pth"), _load(tmp_path / "resumed" / "checkpoint-2.pth")
    for key in ("model", "model_ema"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    assert a["step"] == b["step"]


@pytest.mark.parametrize("use_ema", [False, True], ids=["model", "model_ema"])
def test_eval_mode_reads_eval_ckpt(tree, trained, tmp_path, use_ema):
    from rald_torch.cli.main_ae import build_loaders
    from rald_torch.config import Config
    from rald_torch.train.ae_engine import AEEngine
    from rald_torch.train.checkpoint import load_torch_checkpoint

    out, stats = trained
    ckpt = out / "checkpoint-2.pth"
    d = _cfg_dict(tree, tmp_path / "eval", **{"system.mode": "eval", "eval.ckpt": str(ckpt),
                                              "train.use_ema": use_ema})
    got = _main(tmp_path, d)[None]
    assert (tmp_path / "eval" / "config.yml").exists()
    assert not list((tmp_path / "eval").glob("checkpoint-*"))
    if not use_ema:  # the training run evaluated these params after its last epoch
        assert got == stats
        return
    eng = AEEngine(Config(d), device="cpu")
    want = eng.evaluate(load_torch_checkpoint(ckpt, ema=True), build_loaders(Config(d))[1],
                        print_fn=lambda *_: None)
    assert got == want and got != stats


def test_per_scene_sweep(tree, trained, tmp_path):
    out, stats = trained
    split = json.loads((tree / "split_synth.json").read_text())
    for scene in ("hall", "lab"):
        (tree / f"split_{scene}.json").write_text(json.dumps(split))
    d = _cfg_dict(tree, tmp_path / "sweep", **{
        "system.mode": "eval", "eval.ckpt": str(out / "checkpoint-2.pth"),
        "dataset.split_file": {"hall": "split_hall.json", "lab": "split_lab.json"}})
    results = _main(tmp_path, d)
    assert sorted(results) == ["hall", "lab"]
    for scene in ("hall", "lab"):
        assert results[scene] == stats  # the same val split and weights
        cfg = yaml.safe_load((tmp_path / "sweep" / scene / "config.yml").read_text())
        assert cfg["dataset"]["split_file"] == f"split_{scene}.json"


def test_orbax_directory_and_world_size_raise(tree, jax_trained, tmp_path, monkeypatch):
    from rald_torch.cli import main_ae
    from rald_torch.config import Config

    d = _cfg_dict(tree, tmp_path / "orbax", **{"system.mode": "eval",
                                               "eval.ckpt": str(jax_trained / "checkpoint-2")})
    with pytest.raises(NotImplementedError, match="orbax"):
        main_ae.run(Config(d), device="cpu", print_fn=lambda *_: None)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="WORLD_SIZE"):
        main_ae.run(Config(d), device="cpu", print_fn=lambda *_: None)
