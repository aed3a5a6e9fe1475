"""The port's offline inference CLI (``rald_torch.cli.infer``) and the host
modules it runs on: ``process_radar_cube`` and ``build_query_grid``
bitwise against rald_tpu's, ``write_ply`` byte-identical to rald_tpu's,
the CLI end to end on the CPU with the tiny test config (files, directory
mirroring, pad-last batching, point counts), and the engine options it
honours (``.pth`` checkpoints, the frozen radar encoder,
``eval.cast_params_bf16``, ``fast_inference``)."""
import numpy as np
import pytest
import torch

from rald_torch.config import Config
from torch_parity import tiny_cfg

RADAR = {"norm_intensity": True, "max_intensity": 45, "norm_dopp": True, "max_dopp": 2.4958,
         "tgt_a_dim": 24, "tgt_e_dim": 20}


@pytest.mark.parametrize("upsample", [False, True])
def test_process_radar_cube_is_bitwise_jax(upsample):
    from rald_torch.data.radar_proc import process_radar_cube as t_proc
    from rald_tpu.data.radar_proc import process_radar_cube as j_proc

    rng = np.random.default_rng(1)
    cube = np.stack([rng.uniform(-5, 60, (32, 16, 16)), rng.normal(0, 2, (32, 16, 16)),
                     rng.uniform(size=(32, 16, 16)) < 0.6], axis=-1).astype(np.float32)
    kw = dict(upsample=upsample, tgt_a=24, tgt_e=20)
    got, want = t_proc(cube, **kw), j_proc(cube, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_proc(cube, early_return=True), j_proc(cube, early_return=True))


@pytest.mark.parametrize("aniso,iso,cart", [(True, False, False), (False, True, False),
                                            (True, False, True)])
def test_build_query_grid_is_bitwise_jax(aniso, iso, cart):
    from rald_torch.eval.queries import build_query_grid as t_grid
    from rald_tpu.eval.queries import build_query_grid as j_grid

    lidar = Config({"pc_range": [0, -90, -20, 15.8, 90, 20], "pc_range_cart": [0, -15, -5, 15, 15, 5],
                    "norm_anisotropy": aniso, "norm_isotropy": iso})
    got = t_grid(lidar, 5000, cart, np.random.default_rng(3))
    want = j_grid(lidar, 5000, cart, np.random.default_rng(3))
    assert got.dtype == np.float32 and got.shape == (5000, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colors", [False, True])
def test_write_ply_is_byte_identical(tmp_path, colors):
    from rald_torch.eval.ply import read_ply, write_ply
    from rald_tpu.eval.ply import write_ply as j_write

    rng = np.random.default_rng(4)
    pts = rng.normal(size=(37, 3)).astype(np.float32)
    col = rng.integers(0, 256, size=(37, 3)).astype(np.uint8) if colors else None
    write_ply(tmp_path / "t" / "a.ply", pts, col)
    j_write(tmp_path / "j" / "a.ply", pts, col)
    assert (tmp_path / "t" / "a.ply").read_bytes() == (tmp_path / "j" / "a.ply").read_bytes()
    np.testing.assert_array_equal(read_ply(tmp_path / "t" / "a.ply"), pts)
    write_ply(tmp_path / "e.ply", np.zeros((0, 3)))
    assert read_ply(tmp_path / "e.ply").shape == (0, 3)


def _cli_cfg(tmp_path, **eval_updates):
    cfg = tiny_cfg(Config, eval=eval_updates)
    cfg.dataset.radar.update(RADAR)
    cfg.eval.inference.num_query_points = 2048
    return cfg


def _raw_cubes(root, counts, seed=0):
    rng = np.random.default_rng(seed)
    for seq, n in counts.items():
        d = root / seq / "radar_cube"
        d.mkdir(parents=True)
        for i in range(n):
            cube = np.stack([rng.uniform(0, 60, (32, 16, 16)), rng.normal(0, 1.5, (32, 16, 16)),
                             rng.uniform(size=(32, 16, 16)) < 0.7], axis=-1).astype(np.float32)
            np.save(d / f"{i:04d}.npy", cube)


def test_cli_end_to_end_on_cpu(tmp_path):
    """Raw cubes in two sequences with colliding names, batch 2 (two full
    batches and a padded one): mirrored PLY paths, and each cloud is the
    grid points whose decoded logit passes the threshold, mapped back to
    metres and polar -> cartesian."""
    from rald_torch import geometry as geo
    from rald_torch.cli import infer
    from rald_torch.eval.ply import read_ply
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _cli_cfg(tmp_path)
    _raw_cubes(tmp_path / "in", {"seq_a": 3, "seq_b": 2})
    eng = GenerationEngine(cfg, device="cpu")
    files = infer.collect_inputs(str(tmp_path / "in"))
    grid = infer.query_grid(cfg)
    cubes = np.stack([infer.preprocess(infer.load_cube(f), cfg.dataset.radar) for f in files])
    logits = eng.decode_queries(eng.sample_tokens(cubes, list(range(len(files)))),
                                np.broadcast_to(grid, (len(files),) + grid.shape))
    thr = float(torch.quantile(logits[0], 0.8))
    lines = []
    stats = infer.run(cfg, str(tmp_path / "in"), str(tmp_path / "out"), batch=2, threshold=thr,
                      engine=eng, print_fn=lines.append)
    got = sorted(str(p.relative_to(tmp_path / "out")) for p in (tmp_path / "out").rglob("*.ply"))
    assert got == ["seq_a/radar_cube/0000.ply", "seq_a/radar_cube/0001.ply",
                   "seq_a/radar_cube/0002.ply", "seq_b/radar_cube/0000.ply",
                   "seq_b/radar_cube/0001.ply"]
    assert stats["files"] == 5 and len(lines) == 1 and "5 point clouds" in lines[0]
    want_points = (logits > thr).sum(1).tolist()
    assert stats["points"] == want_points and 0 < want_points[0] < len(grid)
    for i, out in enumerate(infer.output_paths(files, tmp_path / "out")):
        pred = geo.polar2cartesian(geo.inverse_norm_points(grid[(logits[i] > thr).numpy()],
                                                           cfg.dataset.lidar.pc_range))
        np.testing.assert_allclose(read_ply(out), pred, rtol=1e-6, atol=1e-5)
    # the engine the CLI builds itself from the same config (and seed)
    stats2 = infer.run(cfg, str(tmp_path / "in"), str(tmp_path / "out2"), batch=2,
                       threshold=thr, device="cpu", print_fn=lambda *_: None)
    assert stats2["points"] == want_points


def test_cli_preprocessed_npz_and_empty_input(tmp_path):
    from rald_torch.cli import infer

    rng = np.random.default_rng(5)
    (tmp_path / "c").mkdir()
    np.save(tmp_path / "c" / "0000.npy", rng.normal(size=(32, 16, 16, 2)).astype(np.float32))
    np.savez(tmp_path / "c" / "0001.npz",
             radar_cube=rng.normal(size=(32, 16, 16, 2)).astype(np.float32))
    stats = infer.run(_cli_cfg(tmp_path), str(tmp_path / "c"), str(tmp_path / "o"), batch=4,
                      preprocessed=True, device="cpu", print_fn=lambda *_: None)
    assert stats["files"] == 2
    assert sorted(p.name for p in (tmp_path / "o").glob("*.ply")) == ["0000.ply", "0001.ply"]
    with pytest.raises(FileNotFoundError):
        infer.collect_inputs(str(tmp_path / "nothing"))


def test_cli_refuses_checkpoints_it_cannot_read(tmp_path):
    """Missing checkpoints warn (seeded random weights stand in, as in JAX);
    an orbax checkpoint directory raises."""
    from rald_torch.cli import infer

    lines = []
    _raw_cubes(tmp_path / "in", {"s": 1})
    infer.run(_cli_cfg(tmp_path, ckpt=str(tmp_path / "missing")), str(tmp_path / "in"),
              str(tmp_path / "o"), device="cpu", print_fn=lines.append)
    assert lines[:2] == ["WARNING: eval.ckpt missing — sampling with random weights",
                         "WARNING: lidar_ae.ckpt missing — using randomly initialized frozen VAE"]
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(NotImplementedError, match="scripts/orbax_to_pth.py"):
        infer.run(_cli_cfg(tmp_path, ckpt=str(tmp_path / "ckpt")), str(tmp_path / "in"),
                  str(tmp_path / "o"), device="cpu", print_fn=lines.append)


def test_cli_reads_pth_checkpoints_and_the_frozen_encoder(tmp_path):
    """``eval.ckpt`` / ``lidar_ae.ckpt`` / ``radar_enc.ckpt`` as reference
    ``.pth`` files, with the frozen radar encoder: the CLI loads them and
    encodes each cube before sampling, as JAX's CLI does; its clouds are
    those of an engine given the same weights by hand."""
    from rald_torch.cli import infer
    from rald_torch.eval.ply import read_ply
    from rald_torch.train.checkpoint import save_torch_checkpoint
    from rald_torch.train.gen_engine import GenerationEngine

    def frozen_cfg(**ev):
        cfg = _cli_cfg(tmp_path, **ev)
        cfg.ar_model.configs.unfreeze_radar_enc = False
        cfg.radar_enc = {"name": "ae_ch16_mult5_n2_d16", "overrides": {"embed_dim": 4}}
        return cfg

    src = GenerationEngine(frozen_cfg(), device="cpu", seed=3)
    with torch.no_grad():
        src.vae.to_outputs.bias += 0.05
    ckpt = {"ckpt": str(save_torch_checkpoint(tmp_path / "edm.pth", src.model.state_dict()))}
    cfg = frozen_cfg(**ckpt)
    cfg.lidar_ae.ckpt = str(save_torch_checkpoint(tmp_path / "vae.pth", src.vae.state_dict()))
    cfg.radar_enc.ckpt = str(save_torch_checkpoint(tmp_path / "ae.pth", {
        **src.radar_enc.state_dict(), "decoder.conv_out.weight": torch.zeros(1, 8, 3, 3, 3)}))
    _raw_cubes(tmp_path / "in", {"s": 3})
    lines = []
    stats = infer.run(cfg, str(tmp_path / "in"), str(tmp_path / "out"), batch=2, device="cpu",
                      print_fn=lines.append)
    assert lines[:3] == [f"Loaded generation checkpoint from {cfg.eval.ckpt}",
                         f"Loaded frozen VAE from {cfg.lidar_ae.ckpt}",
                         f"Loaded frozen radar encoder from {cfg.radar_enc.ckpt}"]
    assert not any("decoder" in line for line in lines)  # the encoder half is loaded, no note
    files = infer.collect_inputs(str(tmp_path / "in"))
    cubes = np.stack([infer.preprocess(infer.load_cube(f), cfg.dataset.radar) for f in files])
    grid = infer.query_grid(cfg)
    tokens = src.sample_tokens(src.encode_radar(cubes), [0, 1, 2])
    want = (src.decode_queries(tokens, np.broadcast_to(grid, (3,) + grid.shape)) > 0).sum(1)
    assert stats["points"] == want.tolist() and 0 < sum(stats["points"]) < 3 * len(grid)
    for f, n in zip(infer.output_paths(files, tmp_path / "out"), stats["points"]):
        assert len(read_ply(f)) == n


def test_cast_params_bf16_rounds_the_weights(tmp_path):
    """``eval.cast_params_bf16``: the f32 weights are rounded to bf16 before
    the int8 side-tree is built from them, as JAX casts its params."""
    from rald_torch.ops.geglu_kernel import quantize_cols
    from rald_torch.train.gen_engine import GenerationEngine

    inf = dict(tiny_cfg(Config).eval.inference, int8_ff=True)
    plain = GenerationEngine(tiny_cfg(Config, eval={"inference": inf}), device="cpu")
    cast = GenerationEngine(tiny_cfg(Config, eval={"inference": inf, "cast_params_bf16": True}),
                            device="cpu")
    for (k, a), b in zip(plain.model.state_dict().items(), cast.model.state_dict().values()):
        assert b.dtype == torch.float32 and torch.equal(b, a.bfloat16().float()), k
    w1 = cast.model.model.transformer_blocks[0].ff.proj_in.weight
    want, _ = quantize_cols(w1)
    assert torch.equal(cast.model.model.transformer_blocks[0].int8["ff"]["w1q"], want)
    # load_state_dicts rounds what it is given too
    sd = {k: v + 1e-4 for k, v in plain.model.state_dict().items()}
    cast.load_state_dicts(edm_state_dict=sd)
    assert all(torch.equal(v, v.bfloat16().float()) for v in cast.model.state_dict().values())


def test_fast_inference_off_builds_the_plain_models(tmp_path):
    """``system.fast_inference: false``: no fused FF, no folded decode and no
    int8, whatever ``eval.inference`` asks (JAX's model_eval is the model as
    built); the overrides' ``use_fused_attn`` stays; YAML flags of both
    models are accepted."""
    from rald_torch.train.gen_engine import GenerationEngine

    inf = dict(tiny_cfg(Config).eval.inference, int8_ff=True, int8_attn="vout")
    ov = dict(tiny_cfg(Config).ar_model.overrides, use_fused_attn=True)
    vov = dict(tiny_cfg(Config).lidar_ae.overrides, use_fused_ff=False, fold_decode_tail=False)
    eng = GenerationEngine(tiny_cfg(Config, system={"fast_inference": False},
                                    ar_model={"overrides": ov}, lidar_ae={"overrides": vov},
                                    eval={"inference": inf}), device="cpu")
    blocks = eng.model.model.transformer_blocks
    assert all(b.use_fused_attn and not b.use_fused_ff and not b.int8 for b in blocks)
    assert not (eng.use_int8_ff or eng.use_int8_attn)
    assert not eng.vae.fold_decode_tail and not any(b.use_fused_ff for b in eng.vae.layers)
    tok = eng.sample_tokens(np.zeros((1, 32, 16, 16, 3), np.float32), [0])
    assert torch.isfinite(tok).all()
    fast = GenerationEngine(tiny_cfg(Config, eval={"inference": inf}), device="cpu")
    assert all(b.use_fused_ff and set(b.int8) == {"ff", "attn1"}
               for b in fast.model.model.transformer_blocks)
    assert fast.vae.fold_decode_tail and all(b.use_fused_ff for b in fast.vae.layers)


def test_cli_refuses_world_size_above_one(tmp_path, monkeypatch):
    """``WORLD_SIZE=2`` with no rendezvous address: the CLI raises before any
    work, naming ``MASTER_ADDR``, rather than running one rank alone (the
    two-rank split itself runs in ``tests/test_torch_parallel.py``)."""
    from rald_torch.cli import infer

    _raw_cubes(tmp_path / "in", {"s": 1})
    for var in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*MASTER_ADDR"):
        infer.run(_cli_cfg(tmp_path), str(tmp_path / "in"), str(tmp_path / "o"), device="cpu",
                  print_fn=lambda *_: None)
    assert not (tmp_path / "o").exists()


def test_cli_samples_with_churn(tmp_path, monkeypatch):
    """``eval.inference.s_churn > 0`` reaches the CLI's sampling: one churn
    draw per Heun step of each batch, keyed by the frames' seeds, and
    clouds that differ from the churn-free run."""
    import rald_torch.train.gen_engine as ge
    from rald_torch.cli import infer
    from rald_torch.diffusion.edm import sample_churn_noise

    calls = []

    def spy(seeds, step, *a):
        calls.append((list(seeds), step))
        return sample_churn_noise(seeds, step, *a)

    monkeypatch.setattr(ge, "sample_churn_noise", spy)
    _raw_cubes(tmp_path / "in", {"s": 3})
    churn = {"s_churn": 40.0, "s_min": 0.05, "s_max": 50.0, "s_noise": 1.003, "num_steps": 4}
    got = {}
    for label, inf in (("churn", churn), ("plain", dict(churn, s_churn=0.0))):
        cfg = _cli_cfg(tmp_path)
        cfg.eval.inference.update(inf)
        got[label] = infer.run(cfg, str(tmp_path / "in"), str(tmp_path / label), batch=2,
                               device="cpu", threshold=0.0, print_fn=lambda *_: None)["points"]
    assert calls == [([0, 1], s) for s in range(4)] + [([2, 3], s) for s in range(4)]
    assert got["churn"] != got["plain"] or not any(got["plain"])
