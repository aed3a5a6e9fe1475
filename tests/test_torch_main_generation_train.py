"""The port's training entry point ``python -m rald_torch.cli.main_generation``
(``system.mode: train``) and ``python -m rald_torch.cli.main_cache``, on the
CPU with the JAX test harness's tiny config over a synthetic ColoRadar tree
(two train sequences of 4 frames, batch 2: 4 steps an epoch):

- 2 epochs: ``log.txt`` holds one record an epoch (``train_lr`` /
  ``train_loss`` / ``train_grad_norm`` / ``epoch``, and ``val_*`` after the
  ``eval_freq`` epoch), ``checkpoint-{0,1}.pth`` hold params, EMA,
  optimizer state, step and epoch;
- resume from ``checkpoint-0.pth`` runs epoch 1 only and ends bitwise
  equal to the uninterrupted run (checkpoint and log record);
- the eval CLI on the trainer's checkpoint loads ``model_ema`` with
  ``train.use_ema`` and ``model`` without;
- ``main_cache`` writes one ``res_tokens`` file a train frame, equal to the
  dataset's ``cache_latent`` reading, and an epoch trains from them."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from rald_torch.config import Config as TConfig

STEPS = 4  # train frames / batch


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_torch.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("train_tree")
    make_synthetic_coloradar(root, num_train_seqs=2, num_eval_seqs=1, frames_per_seq=4,
                             points_per_frame=2000, radar_shape=(32, 16, 16), seed=2)
    return root


def _cfg(root, out, **updates) -> TConfig:
    """``tests/test_generation.py::_gen_cfg``'s train config for the port."""
    from test_generation import _gen_cfg

    d = json.loads(json.dumps(_gen_cfg(root, "train").to_dict()))
    d["system"].update(output_dir=str(out), log_dir=None)
    d["dataset"].update(batch_size=2, num_workers=2)
    d["train"].update(save_ckpt_freq=1, eval_freq=2)
    d["eval"]["inference"].update(num_query_points=256, refine_query=False)
    d["lidar_ae"]["cache_path"] = str(out / "latent_cache")
    for k, v in updates.items():
        section, key = k.split(".", 1)
        d[section][key] = v
    return TConfig(d)


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """The CLI on a YAML: 2 epochs, a checkpoint each, eval after epoch 1."""
    from rald_torch.cli import main_generation as mg

    out = tmp_path_factory.mktemp("run")
    path = out / "train.yml"
    path.write_text(yaml.safe_dump(_cfg(tree, out / "out").to_dict()))
    mg.main(["--config", str(path), "--device", "cpu"])
    return out / "out"


def _records(out):
    return [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_train_mode_logs_and_checkpoints(trained):
    records = _records(trained)
    assert [r["epoch"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite([r["train_loss"], r["train_grad_norm"], r["train_lr"]]).all()
    assert not any(k.startswith("val_") for k in records[0])
    assert sorted(k for k in records[1] if k.startswith("val_")) == [
        "val_accuracy", "val_cd", "val_fscore", "val_iou", "val_loss"]
    assert np.isfinite(records[1]["val_loss"])
    for epoch in (0, 1):
        ckpt = _load(trained / f"checkpoint-{epoch}.pth")
        assert ckpt["epoch"] == epoch and ckpt["step"] == STEPS * (epoch + 1)
        assert ckpt["optimizer"]["count"] == STEPS * (epoch + 1)
        assert sorted(ckpt["model"]) == sorted(ckpt["model_ema"]) == sorted(ckpt["optimizer"]["mu"])
        moved = [not torch.equal(ckpt["model"][k], ckpt["model_ema"][k]) for k in ckpt["model"]]
        assert any(moved)
    # the weights are in the reference layout: the eval DiT takes them strictly
    from rald_torch.config import load_config
    from rald_torch.train.gen_engine import GenerationEngine

    eng = GenerationEngine(load_config(trained / "config.yml"), device="cpu")
    eng.load_state_dicts(edm_state_dict=_load(trained / "checkpoint-1.pth")["model"])


def test_resume_equals_uninterrupted_run(tree, trained, tmp_path):
    import shutil

    from rald_torch.cli import main_generation as mg

    out = tmp_path / "resumed"
    out.mkdir()
    shutil.copy(trained / "checkpoint-0.pth", out / "from.pth")
    lines = []
    mg.run(_cfg(tree, out, **{"train.resume": str(out / "from.pth")}), device="cpu",
           print_fn=lines.append)
    assert "resumed from epoch 0" in lines
    assert not (out / "checkpoint-0.pth").exists()
    assert _records(out) == _records(trained)[1:]
    _assert_trees_equal(_load(out / "checkpoint-1.pth"), _load(trained / "checkpoint-1.pth"))


@pytest.mark.parametrize("use_ema", [True, False])
def test_eval_cli_reads_trainer_checkpoint(tree, trained, tmp_path, use_ema):
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine

    ckpt = _load(trained / "checkpoint-1.pth")
    cfg = _cfg(tree, tmp_path, **{"system.mode": "eval", "train.use_ema": use_ema})
    cfg.eval.ckpt = str(trained / "checkpoint-1.pth")
    eng = GenerationEngine(cfg, device="cpu")
    lines = []
    mg.load_eval_checkpoint(cfg, eng, lines.append)
    want = ckpt["model_ema" if use_ema else "model"]
    got = eng.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    stats = mg.run(cfg, engine=eng, print_fn=lines.append)
    assert np.isfinite(stats["loss"])
    assert f"Using {'EMA' if use_ema else 'model'} parameters for evaluation" in lines


def test_main_cache_refuses_world_size_above_one(tree, tmp_path, monkeypatch):
    """``WORLD_SIZE=2`` with no rendezvous address: the CLI raises before it
    writes anything, naming ``MASTER_ADDR``, rather than caching alone (the
    two-rank cache itself runs in ``tests/test_torch_parallel.py``)."""
    from rald_torch.cli import main_cache

    cfg = _cfg(tree, tmp_path, **{"train.epochs": 1, "train.eval_freq": 0})
    for var in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*MASTER_ADDR"):
        main_cache.run(cfg, device="cpu", print_fn=lambda *_: None)
    assert not (tmp_path / "latent_cache").exists()


def test_main_cache_then_cached_latent_epoch(tree, tmp_path):
    from rald_torch.cli import main_cache, main_generation as mg
    from rald_torch.data.registry import get_dataset

    cfg = _cfg(tree, tmp_path, **{"train.epochs": 1, "train.eval_freq": 0})
    lines = []
    path = main_cache.run(cfg, device="cpu", print_fn=lines.append)
    assert path == tmp_path / "latent_cache" / cfg.lidar_ae.name / cfg.lidar_ae.cache_name
    files = sorted(path.glob("*/*.npz"))
    assert len(files) == 2 * STEPS
    with np.load(files[0]) as z:
        tokens = z["res_tokens"]
    assert tokens.shape == (16, 8) and np.isfinite(tokens).all()
    assert any(l.startswith("Caching time") for l in lines)

    cached = _cfg(tree, tmp_path, **{"train.epochs": 1, "train.eval_freq": 0,
                                     "train.use_cache_latent": True})
    mg.run(cached, device="cpu", print_fn=lines.append)
    ds = get_dataset(cached.dataset, "train", seed=0)
    item = ds[0]
    lidar = Path(item["lidar_path"])
    with np.load(path / lidar.parts[-3] / (lidar.parts[-1] + ".npz")) as z:
        np.testing.assert_array_equal(item["cache_latent"], z["res_tokens"])
    record = _records(tmp_path)[-1]
    assert record["epoch"] == 0 and np.isfinite(record["train_loss"])
