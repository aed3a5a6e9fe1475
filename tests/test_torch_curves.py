"""The convergence recipe's port (``rald_torch.cli.curves_configs``,
``rerun_to_convergence``, ``render_curves``) on the CPU:

- ``curves_configs`` writes JAX's ``ae.yml`` / ``gen.yml``
  (``scripts/curves_configs.py``, run by path under ``JAX_PLATFORMS=cpu``)
  key by key, the root aside, except ``lidar_ae.ckpt``: the port names the
  ``.pth`` file its ``main_ae`` writes (``out_ae/checkpoint-59.pth``), JAX
  the orbax directory (``out_ae/checkpoint-59``). A stub split file in each
  root keeps both scripts from writing the full-size tree;
- ``--gen-epochs`` patches ``gen.yml`` as ``scripts/rerun_to_convergence.sh``
  does, and nothing else;
- a tiny recipe (VAE and DiT at depth 2, 128 points a frame, 2 + 2 epochs)
  runs ``main_ae`` -> ``main_cache`` -> ``main_generation`` through the
  port's own files: stage 2 and the cache load the stage-1 file
  ``out_ae/checkpoint-1.pth`` with no warning, and each cached latent
  equals ``GenerationEngine.vae_encode`` of its frame under that file's
  weights (the frame's own posterior draw), within 1e-6;
- the chain raises, before it trains, when ``gen.yml`` names a stage-1
  path that stage 1 never writes (JAX's orbax name), and the check raises
  when the named file is missing after stage 1;
- ``render_curves`` on the two archived JAX logs prints the JAX script's
  sparklines, tables and best-point line (the prose and headers aside)."""
import contextlib
import io
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "docs" / "artifacts"


def _stub_split(root: Path) -> None:
    (root / "data").mkdir(parents=True)
    (root / "data" / "split_synth.json").write_text("{}")


def _rooted(d, root: str):
    """``d`` with every string that starts with ``root`` re-rooted at ROOT."""
    if isinstance(d, dict):
        return {k: _rooted(v, root) for k, v in d.items()}
    if isinstance(d, list):
        return [_rooted(v, root) for v in d]
    if isinstance(d, str) and d.startswith(root):
        return "ROOT" + d[len(root):]
    return d


def test_yamls_equal_jax_except_the_pth_path(tmp_path, monkeypatch):
    from rald_torch.cli import curves_configs

    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _stub_split(jax_root)
    _stub_split(port_root)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", ["curves_configs.py", str(jax_root)])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(str(REPO / "scripts" / "curves_configs.py"), run_name="__main__")
    curves_configs.main(port_root, print_fn=lambda *a: None)
    for name in ("ae", "gen"):
        jax_d = _rooted(yaml.safe_load((jax_root / f"{name}.yml").read_text()), str(jax_root))
        port_d = _rooted(yaml.safe_load((port_root / f"{name}.yml").read_text()), str(port_root))
        if name == "gen":
            assert jax_d["lidar_ae"].pop("ckpt") == "ROOT/out_ae/checkpoint-59"
            assert port_d["lidar_ae"].pop("ckpt") == "ROOT/out_ae/checkpoint-59.pth"
        assert port_d == jax_d, name


def test_gen_epochs_patch_is_the_shell_scripts(tmp_path):
    from rald_torch.cli import curves_configs
    from rald_torch.cli.rerun_to_convergence import patch_gen_epochs

    _stub_split(tmp_path)
    _, gen_yml = curves_configs.main(tmp_path, print_fn=lambda *a: None)
    before = yaml.safe_load(gen_yml.read_text())
    patch_gen_epochs(gen_yml, 480)
    after = yaml.safe_load(gen_yml.read_text())
    before["train"].update(epochs=480, eval_freq=16, save_ckpt_freq=40)
    assert after == before


TINY_DIT = {"n_latents": 16, "channels": 8, "depth": 2, "n_heads": 2, "d_head": 16}
TINY_VAE = {"dim": 64, "queries_dim": 64, "depth": 2, "num_latents": 16, "latent_dim": 8,
            "heads": 4, "dim_head": 16}
TINY_RADAR = {"radar_token_channel": 32, "enc_radar_r_dim": 2, "enc_radar_a_dim": 1,
              "enc_radar_e_dim": 1, "enc_radar_ch": 4, "enc_hidden_ch": 8}


def _tiny_recipe(root: Path) -> tuple:
    """The recipe's files at a tiny size: the tree (2 train sequences of 4
    frames, 1500 points, radar (32, 16, 16) without upsampling), depth-2
    models, 128 points a frame, batch 2, float32, 2 + 2 epochs, every
    evaluation on 256 queries."""
    from rald_torch.cli import curves_configs

    ae_yml, gen_yml = curves_configs.main(
        root, num_train_seqs=2, num_eval_seqs=1, frames_per_seq=4, points_per_frame=1500,
        radar_shape=(32, 16, 16), ae_epochs=2, gen_epochs=2, print_fn=lambda *a: None)
    for path in (ae_yml, gen_yml):
        d = yaml.safe_load(path.read_text())
        d["system"]["compute_dtype"] = "float32"
        ds = d["dataset"]
        ds["lidar"]["num_samples"] = 128
        ds["radar"].update(input_r_dim=32, input_a_dim=16, input_e_dim=16, upsample=False,
                           upsample_on_device=False)
        ds.update(batch_size=2, eval_batch_size=2, query_aug_num=256)
        d["train"].update(eval_freq=2, save_ckpt_freq=1)
        d["eval"]["inference"]["num_query_points"] = 256
        d["lidar_ae"]["overrides"] = dict(TINY_VAE)
        if "ar_model" in d:
            d["ar_model"]["overrides"] = dict(TINY_DIT)
            d["ar_model"]["configs"].update(TINY_RADAR)
        path.write_text(yaml.safe_dump(d))
    return ae_yml, gen_yml


@pytest.fixture(scope="module")
def tiny_chain(tmp_path_factory):
    from rald_torch.cli import rerun_to_convergence

    root = tmp_path_factory.mktemp("curves")
    ae_yml, gen_yml = _tiny_recipe(root)
    lines = []
    out = rerun_to_convergence.chain(ae_yml, gen_yml, device="cpu", print_fn=lines.append)
    return root, gen_yml, out, lines


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_tiny_chain_runs_through_the_ports_own_files(tiny_chain):
    root, _, out, lines = tiny_chain
    stage1 = root / "out_ae" / "checkpoint-1.pth"
    assert stage1.is_file()
    loaded = [l for l in lines if l.startswith("Loaded frozen VAE from")]
    assert loaded == [f"Loaded frozen VAE from {stage1}"] * 2  # main_cache, main_generation
    assert not [l for l in lines if "WARNING" in l]
    ae, gen = _records(root / "out_ae" / "log.txt"), _records(root / "out_gen" / "log.txt")
    assert [r["epoch"] for r in ae] == [0, 1] and [r["epoch"] for r in gen] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in ae + gen)
    assert "val_iou" in ae[1] and "val_cd" in gen[1] and np.isfinite(gen[1]["val_iou"])
    assert (root / "out_gen" / "checkpoint-1.pth").is_file()
    assert out["ae"]["iou"] == ae[1]["val_iou"]


def test_cached_latents_are_the_stage1_files_encodings(tiny_chain):
    from rald_torch.cli.main_generation import load_frozen_modules
    from rald_torch.config import finalize_dirs, load_config
    from rald_torch.data.registry import get_dataset
    from rald_torch.train.gen_engine import GenerationEngine

    root, gen_yml, out, _ = tiny_chain
    cfg = finalize_dirs(load_config(gen_yml))
    eng = GenerationEngine(cfg, device="cpu")
    load_frozen_modules(cfg, eng, print_fn=lambda *a: None)
    ds = get_dataset(cfg.dataset, "train", seed=0)
    ds.set_load_query(True)
    ds.set_load_radar(False)
    assert len(ds) == 8
    for i in range(len(ds)):
        item = ds[i]
        p = Path(item["lidar_path"])
        cached = np.load(Path(out["cache"]) / p.parts[-3] / (p.parts[-1] + ".npz"))["res_tokens"]
        want = eng.vae_encode(item["lidar_points"][None], eps=eng.frame_eps([i]))[0].numpy()
        np.testing.assert_allclose(cached, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["jax_orbax_name", "file_missing_after_stage1"])
def test_chain_raises_on_a_stage1_path_that_does_not_exist(tmp_path, case):
    from rald_torch.cli import rerun_to_convergence
    from rald_torch.config import finalize_dirs, load_config

    ae_yml, gen_yml = _tiny_recipe(tmp_path)
    if case == "jax_orbax_name":
        d = yaml.safe_load(gen_yml.read_text())
        d["lidar_ae"]["ckpt"] = str(tmp_path / "out_ae" / "checkpoint-1")
        gen_yml.write_text(yaml.safe_dump(d))
        with pytest.raises(FileNotFoundError, match="random frozen VAE"):
            rerun_to_convergence.chain(ae_yml, gen_yml, device="cpu", print_fn=lambda *a: None)
        assert not (tmp_path / "out_ae").exists()  # raised before stage 1 trained
    else:
        ae_cfg, gen_cfg = (finalize_dirs(load_config(p)) for p in (ae_yml, gen_yml))
        assert rerun_to_convergence.check_stage1_checkpoint(ae_cfg, gen_cfg, trained=False)
        with pytest.raises(FileNotFoundError, match="stage 1 wrote no"):
            rerun_to_convergence.check_stage1_checkpoint(ae_cfg, gen_cfg)


def _shared_lines(text: str) -> list:
    """The lines both renderers print from the logs: sparklines, table rows
    and the best-point line."""
    keep = ("val ", "| ", "|---", "Best stage-2", "(table subsampled")
    return [l for l in text.splitlines() if l.startswith(keep)]


def test_render_curves_prints_the_jax_scripts_tables(monkeypatch):
    from rald_torch.cli import render_curves

    logs = [str(ARTIFACTS / f"curves_stage{i}_log.jsonl") for i in (1, 2)]
    monkeypatch.setattr(sys, "argv", ["render_curves.py", *logs])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(REPO / "scripts" / "render_curves.py"), run_name="__main__")
    want = _shared_lines(buf.getvalue())
    got = "\n".join(render_curves.render(*logs, device="NVIDIA H100 80GB HBM3, 700.00 W"))
    assert len(want) > 60 and _shared_lines(got) == want
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in got.splitlines()[2]
    with_ref = render_curves.render(*logs, device="card", reference=logs)
    assert "| 1 | 59 | 0.9649 | 0.9649 | 0.1866 | 0.1866 |" in with_ref
    assert "| 2 | 119 | 0.5358 | 0.5358 | 0.5532 | 0.5532 |" in with_ref
