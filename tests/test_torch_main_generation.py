"""The port's eval entry point ``python -m rald_torch.cli.main_generation`` and
its ``.pth`` checkpoints, on the CPU with the JAX test harness's tiny config:

- eval mode over a two-scene ``split_file`` dict: one result per scene,
  ``config.yml`` per scene, PLY dumps per scene, equal to the engine's own
  ``evaluate`` on the same config;
- an unknown ``system.mode``, train mode under ``WORLD_SIZE`` > 1 with no
  rendezvous address (naming ``MASTER_ADDR``) and an orbax directory in
  ``eval.ckpt`` raise;
- checkpoint round trip: the port's weights -> ``.pth`` -> the port reads
  them back strictly, and rald_tpu's own ``load_torch_checkpoint`` +
  ``convert_{edm,vae,radar_autoencoder}_state_dict`` read the same files
  into JAX's parameter trees (so the files are the reference layout);
- the frozen radar encoder's config with ``eval.ckpt`` / ``lidar_ae.ckpt``
  / ``radar_enc.ckpt`` files: loaded, the engine taking the autoencoder's
  encoder half and a whole ``RadarAutoencoder`` the file as it is."""
import json

import jax
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from rald_torch.config import Config as TConfig


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from rald_torch.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("gen_tree")
    make_synthetic_coloradar(root, num_train_seqs=1, num_eval_seqs=1, frames_per_seq=2,
                             points_per_frame=2000, radar_shape=(32, 16, 16), seed=1)
    split = json.loads((root / "split_synth.json").read_text())
    # two scenes: the test split, and the val sequence as a second test scene
    (root / "split_a.json").write_text(json.dumps({**split, "test": split["test"]}))
    (root / "split_b.json").write_text(json.dumps({**split, "test": split["val"]}))
    return root


def _cfg(root, out, **updates) -> TConfig:
    """``tests/test_generation.py::_gen_cfg``'s eval config for the port."""
    from test_generation import _gen_cfg

    d = json.loads(json.dumps(_gen_cfg(root, "eval").to_dict()))
    d["system"].update(output_dir=str(out / "out"), expname="exp")
    d["eval"].update(store_base_dir=str(out / "dumps"))
    d["eval"]["inference"]["num_query_points"] = 512
    for k, v in updates.items():
        section, key = k.split(".", 1)
        d[section][key] = v
    return TConfig(d)


def test_main_generation_sweeps_scenes(tree, tmp_path):
    from rald_torch.cli import main_generation as mg
    from rald_torch.config import expand_experiment_sweep, finalize_dirs, load_config
    from rald_torch.eval.ply import read_ply
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _cfg(tree, tmp_path, **{"dataset.split_file": {"a": "split_a.json",
                                                         "b": "split_b.json"}})
    path = tmp_path / "eval.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    results = mg.main(["--config", str(path), "--device", "cpu"])
    assert list(results) == ["a", "b"]
    for scene, seq in (("a", "synth_seq_2"), ("b", "synth_seq_1")):
        stats = results[scene]
        assert sorted(stats) == ["accuracy", "cd", "fscore", "iou", "loss"]
        assert np.isfinite(stats["loss"]) and 0 <= stats["iou"] <= 1
        saved = load_config(tmp_path / "out" / "exp" / scene / "config.yml")
        assert saved.dataset.split_file == f"split_{scene}.json"
        plys = sorted((tmp_path / "dumps" / "test_exp" / seq / "pred_pc").glob("*.ply"))
        assert [p.name for p in plys] == ["0000.ply", "0001.ply"]
        assert all(read_ply(p).shape[1] == 3 for p in plys)
    # the engine itself on the same per-scene config: the same numbers
    for scene, sub in expand_experiment_sweep(finalize_dirs(load_config(path))):
        loader = mg.build_eval_loader(sub, "eval")
        want = GenerationEngine(sub, device="cpu").evaluate(loader, print_fn=lambda *_: None)
        assert results[scene] == want


def test_main_generation_refuses_train_mode_and_orbax(tree, tmp_path, monkeypatch):
    from rald_torch.cli import main_generation as mg

    with pytest.raises(NotImplementedError, match="unknown system.mode"):
        mg.run(_cfg(tree, tmp_path, **{"system.mode": "cache"}), device="cpu")
    with monkeypatch.context() as m:
        for var in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
            m.delenv(var, raising=False)
        m.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*MASTER_ADDR"):
            mg.run(_cfg(tree, tmp_path, **{"system.mode": "train"}), device="cpu")
    (tmp_path / "checkpoint-9").mkdir()
    for key in ("eval.ckpt", "lidar_ae.ckpt"):
        cfg = _cfg(tree, tmp_path, **{key: str(tmp_path / "checkpoint-9")})
        with pytest.raises(NotImplementedError, match="orbax"):
            mg.run(cfg, device="cpu", print_fn=lambda *_: None)


def _decoder_state_dict(ch, ch_mult, num_res_blocks, z_ch, out_ch, gen) -> dict:
    """Reference-layout ``decoder.*`` keys of a radar autoencoder (its
    ``RadarDecoder3D``), built here from the port's own blocks, apart from
    the port's decoder: conv_in, mid, ``up.<level>.block.<j>`` (num_res_blocks + 1
    each), ``up.<level>.upsample.conv`` above level 0, norm_out, conv_out."""
    from rald_torch.models.radar_encoder3d import AttnBlock3D, ResnetBlock3D, _group_norm
    from rald_torch.train.gen_engine import init_random_weights

    dec = nn.Module()
    block_in = ch * ch_mult[-1]
    dec.conv_in = nn.Conv3d(z_ch, block_in, 3, padding=1)
    dec.mid = nn.Module()
    dec.mid.block_1, dec.mid.attn_1 = ResnetBlock3D(block_in, block_in), AttnBlock3D(block_in)
    dec.mid.block_2 = ResnetBlock3D(block_in, block_in)
    dec.up = nn.ModuleList([nn.Module() for _ in ch_mult])
    for level in reversed(range(len(ch_mult))):
        blocks = []
        for _ in range(num_res_blocks + 1):
            blocks.append(ResnetBlock3D(block_in, ch * ch_mult[level]))
            block_in = ch * ch_mult[level]
        dec.up[level].block = nn.ModuleList(blocks)
        if level:
            dec.up[level].upsample = nn.Module()
            dec.up[level].upsample.conv = nn.Conv3d(block_in, block_in, 3, padding=1)
    dec.norm_out = _group_norm(block_in)
    dec.conv_out = nn.Conv3d(block_in, out_ch, 3, padding=1)
    init_random_weights(dec, gen)
    return {f"decoder.{k}": v for k, v in dec.state_dict().items()}


RADAR_ENC = {"name": "ae_ch16_mult5_n2_d16", "overrides": {"embed_dim": 4}}


def _frozen_cfg(root, out, **updates):
    cfg = _cfg(root, out, **updates)
    cfg.ar_model.configs.unfreeze_radar_enc = False
    cfg.radar_enc = dict(RADAR_ENC, ckpt=updates.get("radar_enc.ckpt"))
    return cfg


def _write_checkpoints(eng, out) -> dict:
    """The engine's weights as reference ``.pth`` files: EDM, VAE and, with
    a frozen encoder, a whole radar autoencoder (decoder keys included)."""
    from rald_torch.train.checkpoint import save_torch_checkpoint

    paths = {"eval.ckpt": save_torch_checkpoint(out / "edm.pth", eng.model.state_dict()),
             "lidar_ae.ckpt": save_torch_checkpoint(out / "vae.pth", eng.vae.state_dict())}
    if eng.radar_enc is not None:
        dec = _decoder_state_dict(16, (1, 1, 2, 2, 4), 2, 4, 1, torch.Generator().manual_seed(3))
        paths["radar_enc.ckpt"] = save_torch_checkpoint(
            out / "radar_ae.pth", {**eng.radar_enc.state_dict(), **dec})
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("frozen", [False, True])
def test_checkpoint_round_trip(tree, tmp_path, frozen):
    from rald_torch.cli.main_generation import load_eval_checkpoint, load_frozen_modules
    from rald_torch.models.registry import get_radar_encoder_model
    from rald_torch.train.checkpoint import load_torch_checkpoint
    from rald_torch.convert.flax_params import (
        edm_state_dict_from_flax,
        radar_encoder_state_dict_from_flax,
        vae_state_dict_from_flax,
    )
    from rald_torch.train.gen_engine import GenerationEngine
    from rald_tpu.convert import torch_ckpt as jc

    make = _frozen_cfg if frozen else _cfg
    src = GenerationEngine(make(tree, tmp_path, **{"system.seed": 7}), device="cpu")
    paths = _write_checkpoints(src, tmp_path)
    dst = GenerationEngine(make(tree, tmp_path, **paths), device="cpu")
    lines = []
    load_eval_checkpoint(dst.cfg, dst, lines.append)
    load_frozen_modules(dst.cfg, dst, lines.append)
    for a, b in zip(src.modules(), dst.modules()):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert lines[:2] == [f"Loaded generation checkpoint from {paths['eval.ckpt']}",
                         f"Loaded frozen VAE from {paths['lidar_ae.ckpt']}"]
    # rald_tpu reads the same files into its parameter trees
    edm = jc.convert_edm_state_dict(jc.load_torch_checkpoint(paths["eval.ckpt"]), depth=2)
    vae = jc.convert_vae_state_dict(jc.load_torch_checkpoint(paths["lidar_ae.ckpt"]), depth=2)
    for sd, tree_, mod in ((edm_state_dict_from_flax(edm, depth=2), edm, src.model),
                           (vae_state_dict_from_flax(vae, depth=2), vae, src.vae)):
        want = mod.state_dict()
        assert sorted(sd) == sorted(want)
        assert all(torch.equal(sd[k], want[k]) for k in want)
    if frozen:
        from rald_tpu.config import Config as JConfig
        from rald_tpu.train.gen_engine import GenerationEngine as JEngine

        assert lines[2:] == [f"Loaded frozen radar encoder from {paths['radar_enc.ckpt']}"]
        assert not any(n.startswith("decoder.") for n in dst.radar_enc.state_dict())
        whole = get_radar_encoder_model(dst.cfg.radar_enc.name, in_channels=1,
                                        overrides=dst.cfg.radar_enc.overrides)
        whole.load_state_dict(load_torch_checkpoint(paths["radar_enc.ckpt"]))  # strictly
        ae = jc.convert_radar_autoencoder_state_dict(
            jc.load_torch_checkpoint(paths["radar_enc.ckpt"]))
        jeng = JEngine(JConfig(json.loads(json.dumps(dst.cfg.to_dict()))))
        shapes = jax.eval_shape(jeng.init_radar_enc_params, jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(ae) == jax.tree_util.tree_structure(shapes)
        assert jax.tree_util.tree_map(np.shape, ae) == jax.tree_util.tree_map(
            lambda s: s.shape, shapes)
        sd = radar_encoder_state_dict_from_flax(ae["encoder"], prefix="encoder.")
        want = src.radar_enc.state_dict()
        assert sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in want)
    with pytest.raises(RuntimeError, match="Unexpected key"):  # strictly
        dst.load_state_dicts(edm_state_dict={**src.model.state_dict(),
                                             "model.extra": torch.zeros(1)})


def test_frozen_config_eval_reads_pth_checkpoints(tree, tmp_path):
    """The frozen-encoder config in eval mode with all three ``.pth`` files:
    ``run`` loads them (the autoencoder's encoder half) and gives the stats
    of an engine loaded by hand from the same files."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.checkpoint import load_torch_checkpoint, split_radar_autoencoder
    from rald_torch.train.gen_engine import GenerationEngine

    src = GenerationEngine(_frozen_cfg(tree, tmp_path, **{"system.seed": 5}), device="cpu")
    paths = _write_checkpoints(src, tmp_path)
    cfg = _frozen_cfg(tree, tmp_path, **paths, **{"eval.store_pc": False})
    lines = []
    got = mg.run(cfg, device="cpu", print_fn=lines.append)
    assert sum(l.startswith("Loaded ") for l in lines) == 3
    assert not any("decoder" in l for l in lines)
    eng = GenerationEngine(cfg, device="cpu")
    sd, dec = split_radar_autoencoder(load_torch_checkpoint(paths["radar_enc.ckpt"]))
    assert "decoder.conv_in.weight" in dec and all(k.startswith("decoder.") for k in dec)
    eng.load_state_dicts(load_torch_checkpoint(paths["eval.ckpt"]),
                         load_torch_checkpoint(paths["lidar_ae.ckpt"]), sd)
    loader = mg.build_eval_loader(cfg, "eval")
    assert got == eng.evaluate(loader, print_fn=lambda *_: None)
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("store_pc", [True, False])
def test_eval_mode_samples_with_churn(tree, tmp_path, monkeypatch, store_pc):
    """``eval.inference.s_churn > 0`` reaches ``evaluate`` on both of its
    paths (the modular one with PLY dumps, the fused step): one churn draw
    per Heun step of each batch, keyed by the batch's prior seeds."""
    import rald_torch.train.gen_engine as ge
    from rald_torch.cli import main_generation as mg
    from rald_torch.diffusion.edm import sample_churn_noise

    calls = []

    def spy(seeds, step, *a):
        calls.append((list(seeds), step))
        return sample_churn_noise(seeds, step, *a)

    monkeypatch.setattr(ge, "sample_churn_noise", spy)
    cfg = _cfg(tree, tmp_path, **{"eval.store_pc": store_pc})
    cfg.eval.inference.update(s_churn=40.0, s_min=0.05, s_max=50.0, s_noise=1.003, num_steps=4)
    stats = mg.run(cfg, device="cpu", print_fn=lambda *_: None)
    assert calls == [([it], s) for it in range(2) for s in range(4)]
    assert np.isfinite(stats["loss"]) and 0 <= stats["iou"] <= 1
