"""The port's preprocessing chain against ``rald_tpu``'s, file by file.

One raw ColoRadar-layout tree (``tests/test_preprocess_cli.py``'s: int16
ADC frames, 4-attribute LiDAR scans, alignment index files) is written once.
JAX's chain and the port's chain (``device="cpu"``) each run on it into
their own output tree: relink -> preprocess_lidar -> preprocess_radar
(train, then ``--test-set``) -> cache_cfar -> dump_voxel.

Bars, stated before the runs:
- ``lidar_sc/*.bin``: bitwise (host numpy on both sides);
- ``radarcube_raw`` / ``radarcube_high_res``: ``raeivv_map``'s bars
  (dB within 1e-3 abs, velocity and validity equal on >= 99 % of cells);
- ``radar_cfar_low_thrd``: equal row counts, >= 99.9 % of rows equal;
- voxel ``.npy`` dicts: loaded content bitwise (keys, dtypes, arrays; the
  pickled bytes are not compared);
- relink symlinks: the same links to the same targets;
- dataset items over each side's tree: every array bitwise, the radar cube
  (from the cubes above) to its bars.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test worker)
from test_preprocess_cli import FRAMES, RAW_FRAMES, SEQS, _antenna_file, _chirp_yaml

LIDAR_CFG = {
    "FOV": {"max_range": 15.86, "az_range": [-90, 90], "el_range": [-20, 20]},
    "pc_range": [0, -90, -20, 15.8, 90, 20],
    "voxel_size": [0.05, 0.25, 0.5],
    "voxel_max_num_points": 10,
    "max_voxels": 50000,
}
CONE_DIR = "cone_sc_0.05_0.25_0.5"


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The raw tree of ``test_preprocess_cli.py`` (same seed, same draws),
    with a ``calib`` directory for the relinker, and the chirp configs."""
    root = tmp_path_factory.mktemp("raw_coloradar")
    rng = np.random.default_rng(0)
    idx = [0, 2, 4][:FRAMES]
    for seq in SEQS:
        adc_dir = root / seq / "single_chip" / "adc_samples" / "data"
        adc_dir.mkdir(parents=True)
        for i in range(RAW_FRAMES):
            rng.integers(-200, 200, size=(3, 4, 32, 64, 2), dtype=np.int16).tofile(
                adc_dir / f"frame_{i}.bin")
        (adc_dir.parent / "radar_index_sequence.txt").write_text("\n".join(map(str, idx)))
        lidar_dir = root / seq / "lidar" / "pointclouds"
        lidar_dir.mkdir(parents=True)
        for i in range(RAW_FRAMES):
            pts = rng.uniform(-5, 10, size=(2000, 4)).astype(np.float32)
            pts[:50] = 0.0  # zero returns to be dropped
            pts.tofile(lidar_dir / f"lidar_pointcloud_{i}.bin")
        (lidar_dir.parent / "lidar_index_sequence.txt").write_text("\n".join(map(str, idx)))
    (root / "calib").mkdir()
    cfg_dir = tmp_path_factory.mktemp("cfg")
    _chirp_yaml(cfg_dir / "chirp.yml")
    _chirp_yaml(cfg_dir / "chirp_test.yml", az_fft=16, el_fft=8)
    _antenna_file(cfg_dir / "antenna.txt")
    return root, cfg_dir


def _cfg(cls, raw, out: Path, voxel_out: Path, chirp: str = "chirp.yml"):
    root, cfg_dir = raw
    out.mkdir(parents=True, exist_ok=True)
    (out / "split_synth.json").write_text(json.dumps({"train": [SEQS[0]], "val": [], "test": [SEQS[1]]}))
    return cls({
        "root_dir": str(root), "output_dir": str(out), "voxel_output_dir": str(voxel_out),
        "split_file": "split_synth.json", "split": "test", "num_workers": 1,
        "single_chip_mode": {
            "lidar": LIDAR_CFG,
            "radar": {
                "config": str(cfg_dir / chirp),
                "antenna_file_path": str(cfg_dir / "antenna.txt"),
                "cfar": {"input_r_dim": 64, "input_a_dim": 16, "input_e_dim": 8,
                         "tgt_r_dim": 64, "tgt_a_dim": 64, "tgt_e_dim": 32,
                         "cfar_num_point": 4096},
            },
        },
    })


def _jax_chain(raw, base: Path) -> Path:
    from rald_tpu.cli import cache_cfar, dump_voxel, preprocess_lidar, preprocess_radar, relink
    from rald_tpu.config import Config

    cfg = _cfg(Config, raw, base / "out", base / "voxel")
    relink.create_baselink(raw[0], base / "linked")
    preprocess_lidar.run(cfg)
    preprocess_radar.run(cfg)
    preprocess_radar.run(_cfg(Config, raw, base / "out", base / "voxel", "chirp_test.yml"), test_set=True)
    cache_cfar.run(cfg)
    dump_voxel.run(cfg, mode="sc_cone")
    return base


def _port_chain(raw, base: Path) -> tuple[Path, dict]:
    from rald_torch.cli import cache_cfar, dump_voxel, preprocess_lidar, preprocess_radar, relink
    from rald_torch.config import Config

    cfg = _cfg(Config, raw, base / "out", base / "voxel")
    counts = {"relink": relink.main(["--src", str(raw[0]), "--dst", str(base / "linked"),
                                     "--device", "cpu"])}
    counts["lidar"] = preprocess_lidar.run(cfg, device="cpu")
    counts["radar"] = preprocess_radar.run(cfg, device="cpu")
    counts["radar_hires"] = preprocess_radar.run(
        _cfg(Config, raw, base / "out", base / "voxel", "chirp_test.yml"), test_set=True, device="cpu")
    counts["cfar"] = cache_cfar.run(cfg, device="cpu")
    counts["voxel"] = dump_voxel.run(cfg, mode="sc_cone", device="cpu")
    return base, counts


@pytest.fixture(scope="module")
def chains(raw, tmp_path_factory):
    jax_base = _jax_chain(raw, tmp_path_factory.mktemp("jax_chain"))
    port_base, counts = _port_chain(raw, tmp_path_factory.mktemp("port_chain"))
    return jax_base, port_base, counts


def _pairs(chains, rel: str, pattern: str = "*.bin"):
    jax_base, port_base, _ = chains
    out = []
    for seq in SEQS:
        j = sorted((jax_base / "out" / seq / rel).glob(pattern))
        t = sorted((port_base / "out" / seq / rel).glob(pattern))
        assert [p.name for p in t] == [p.name for p in j]
        out += list(zip(j, t))
    return out


def test_counts(chains):
    n = len(SEQS) * FRAMES
    assert chains[2] == {"relink": len(SEQS), "lidar": n, "radar": n, "radar_hires": FRAMES,
                         "cfar": FRAMES, "voxel": n}


def test_lidar_sc_is_bitwise(chains):
    pairs = _pairs(chains, "lidar_sc")
    assert len(pairs) == len(SEQS) * FRAMES
    for j, t in pairs:
        assert t.read_bytes() == j.read_bytes(), t


@pytest.mark.parametrize("rel,shape", [("single_chip/radarcube_raw", (64, 8, 2, 3)),
                                       ("single_chip/radarcube_high_res", (64, 16, 8, 3))])
def test_radar_cubes_match(chains, rel, shape):
    pairs = _pairs(chains, rel)
    assert len(pairs) == (len(SEQS) if rel.endswith("raw") else 1) * FRAMES
    for j, t in pairs:
        want = np.fromfile(j, np.float32).reshape(shape)
        got = np.fromfile(t, np.float32).reshape(shape)
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-3)
        assert (got[..., 1] == want[..., 1]).mean() >= 0.99
        assert (got[..., 2] == want[..., 2]).mean() >= 0.99


def test_cfar_points_match(chains):
    pairs = _pairs(chains, "single_chip/radar_cfar_low_thrd")
    assert len(pairs) == FRAMES
    for j, t in pairs:
        want = np.fromfile(j, np.float32).reshape(-1, 3)
        got = np.fromfile(t, np.float32).reshape(-1, 3)
        assert got.shape == want.shape and 0 < len(got) <= 4096
        assert (got == want).all(axis=1).mean() >= 0.999


def test_voxel_caches_are_bitwise(chains):
    jax_base, port_base, _ = chains
    pairs = _pairs(chains, CONE_DIR, "*.npy")
    assert len(pairs) == len(SEQS) * FRAMES
    for j, t in pairs:
        want = np.load(j, allow_pickle=True).item()
        got = np.load(t, allow_pickle=True).item()
        assert list(got) == list(want) == ["voxels", "voxel_coords", "voxel_num_points"]
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    for seq in SEQS:
        for base in (jax_base, port_base):
            link = base / "out" / seq / CONE_DIR
            assert link.is_symlink() and Path(os.readlink(link)) == base / "voxel" / seq / CONE_DIR


def test_relink_symlinks_are_jax(chains, raw):
    jax_base, port_base, _ = chains

    def links(base):
        d = base / "linked"
        return sorted((str(p.relative_to(d)), os.readlink(p)) for p in d.rglob("*") if p.is_symlink())

    got = links(port_base)
    assert got == links(jax_base)
    assert ("calib", str(raw[0] / "calib")) in got
    assert len(got) == 1 + 5 * len(SEQS)


def _ds_cfg(cls, root: Path, cache_voxel: bool):
    return cls({
        "dataset_name": "AlignedColoRadar", "root_dir": str(root), "split_file": "split_synth.json",
        "radar_type": "scRadar",
        "lidar": {"pc_range": [0, -90, -20, 15.8, 90, 20], "num_point_features": 3,
                  "voxel_size": [0.05, 0.25, 0.5], "max_points_per_voxel": 10,
                  "max_number_of_voxels": 50000, "sampling": True, "num_samples": 256,
                  "query_ratio": 0.0625, "norm_isotropy": False, "norm_anisotropy": True,
                  "cache_voxel": cache_voxel, "view_cone_mode": True},
        "radar": {"input_r_dim": 64, "input_a_dim": 8, "input_e_dim": 2, "input_ch": 3,
                  "upsample": False, "norm_intensity": True, "max_intensity": 45,
                  "norm_dopp": True, "max_dopp": 2.4958},
    })


def _assert_items_equal(got: dict, want: dict, radar_bar: bool):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k == "radar_cube" and radar_bar:
                # (dB, masked velocity) of cubes that differ within their bars
                np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=0, atol=1e-3 / 45)
                assert (g[..., 1] == w[..., 1]).mean() >= 0.99
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_cache_voxel_items_are_bitwise_jax(chains):
    """A ``cache_voxel: true`` item of the port's dataset over the port's
    tree against JAX's over JAX's tree, and against the port's own
    ``cache_voxel: false`` item of the same frame."""
    from rald_tpu.config import Config as JConfig
    from rald_tpu.data.registry import get_dataset as j_get

    from rald_torch.config import Config
    from rald_torch.data.registry import get_dataset

    jax_base, port_base, _ = chains
    ds = get_dataset(_ds_cfg(Config, port_base / "out", True), "train")
    ds_j = j_get(_ds_cfg(JConfig, jax_base / "out", True), "train")
    ds_raw = get_dataset(_ds_cfg(Config, port_base / "out", False), "train")
    assert len(ds) == len(ds_j) == FRAMES
    for i in range(FRAMES):
        item = ds[i]
        assert item["lidar_points"].shape == (256, 3) and item["radar_cube"].shape == (64, 8, 2, 2)
        want = ds_j[i]
        want["lidar_path"] = want["lidar_path"].replace(str(jax_base), str(port_base))
        _assert_items_equal(item, want, radar_bar=True)
        _assert_items_equal(ds_raw[i], item, radar_bar=False)


def test_preprocess_lidar_hust_is_bitwise(tmp_path):
    from rald_tpu.cli import preprocess_lidar as j_lidar
    from rald_tpu.config import Config as JConfig

    from rald_torch.cli import preprocess_lidar
    from rald_torch.config import Config
    from rald_torch.data.synthetic import make_synthetic_hustradar

    make_synthetic_hustradar(tmp_path / "raw", frames_per_seq=2, points_per_frame=1500, seed=3)
    cfg = {"root_dir": str(tmp_path / "raw"), "single_chip_mode": {"lidar": LIDAR_CFG}}
    n = preprocess_lidar.run(Config({**cfg, "output_dir": str(tmp_path / "port")}),
                             dataset="hust", device="cpu")
    assert n == j_lidar.run(JConfig({**cfg, "output_dir": str(tmp_path / "jax")}), dataset="hust") > 0
    files = sorted((tmp_path / "jax").rglob("*.bin"))
    assert len(files) == n
    for f in files:
        assert (tmp_path / "port" / f.relative_to(tmp_path / "jax")).read_bytes() == f.read_bytes()


@pytest.mark.parametrize("cli", ["preprocess_lidar", "preprocess_radar", "cache_cfar", "dump_voxel"])
def test_cascade_mode_raises_as_jax(cli, raw, tmp_path):
    """``--mode cc`` (the cascade radar) raises as JAX's tool does: not
    implemented, or (dump_voxel) no ``lidar_cc`` directory."""
    import importlib

    from rald_tpu.config import Config as JConfig

    from rald_torch.config import Config

    port = importlib.import_module(f"rald_torch.cli.{cli}")
    jax_cli = importlib.import_module(f"rald_tpu.cli.{cli}")
    for mod, cls, kw, out in ((port, Config, {"device": "cpu"}, "port"), (jax_cli, JConfig, {}, "jax")):
        cfg = _cfg(cls, raw, tmp_path / out, tmp_path / f"{out}_voxel")
        if cli == "dump_voxel":
            (tmp_path / out / SEQS[0]).mkdir()
        err = ValueError if cli == "dump_voxel" else NotImplementedError
        with pytest.raises(err, match="lidar_cc|cascade"):
            mod.run(cfg, mode="cc", **kw)


@pytest.mark.parametrize("cli", ["preprocess_lidar", "preprocess_radar", "cache_cfar",
                                 "dump_voxel", "relink"])
def test_clis_default_to_the_card(cli, raw, tmp_path, monkeypatch):
    """Without ``--device`` every CLI asks for the card and, with none,
    raises instead of running on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"rald_torch.cli.{cli}")
    path = tmp_path / "cfg.yml"
    import yaml

    from rald_torch.config import Config

    path.write_text(yaml.safe_dump(_cfg(Config, raw, tmp_path / "out", tmp_path / "vox").to_dict()))
    argv = (["--src", str(raw[0]), "--dst", str(tmp_path / "l")] if cli == "relink"
            else ["--config", str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "l").exists() and not (tmp_path / "out" / SEQS[0]).exists()


def test_cached_item_equals_the_live_item_at_a_voxel_boundary(tmp_path):
    """A return at a range of exactly 10.5 m sits on a voxel boundary:
    10.5 / 0.05 is 210 in float64 (the voxel caches) but 209.99999... with
    0.05 rounded to float32 (JAX's dataset without the cache). The port's
    live item voxelizes as the cache does (ROADMAP C8): its cached and live
    items are equal, and its cached item is JAX's; JAX's two differ."""
    import shutil

    from rald_tpu.cli import dump_voxel as j_dump
    from rald_tpu.config import Config as JConfig
    from rald_tpu.data.registry import get_dataset as j_get

    from rald_torch.cli import dump_voxel
    from rald_torch.config import Config
    from rald_torch.data.registry import get_dataset
    from rald_torch.data.synthetic import make_synthetic_coloradar

    make_synthetic_coloradar(tmp_path / "port", num_train_seqs=1, num_eval_seqs=0, frames_per_seq=1,
                             points_per_frame=2000, radar_shape=(64, 8, 2), seed=4)
    (frame,) = (tmp_path / "port").glob("*/lidar_sc/0000.bin")
    pts = np.fromfile(frame, np.float32).reshape(-1, 3)
    np.concatenate([pts, [[10.5, 0.0, 0.0]]]).astype(np.float32).tofile(frame)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    cfg = {"single_chip_mode": {"lidar": LIDAR_CFG}}
    dump_voxel.run(Config({**cfg, "output_dir": str(tmp_path / "port"),
                           "voxel_output_dir": str(tmp_path / "port_voxel")}), device="cpu")
    j_dump.run(JConfig({**cfg, "output_dir": str(tmp_path / "jax"),
                        "voxel_output_dir": str(tmp_path / "jax_voxel")}))

    from rald_torch import geometry as geo

    polar = geo.cartesian2polar(np.fromfile(frame, np.float32).reshape(-1, 3)).astype(np.float32)
    ds = {(side, cache): (get_dataset if side == "port" else j_get)(
        _ds_cfg(Config if side == "port" else JConfig, tmp_path / side, cache), "train")
        for side in ("port", "jax") for cache in (True, False)}
    coords = {k: d._get_voxels(polar, 0)[1] for k, d in ds.items()}
    np.testing.assert_array_equal(coords["port", False], coords["port", True])
    np.testing.assert_array_equal(coords["port", True], coords["jax", True])
    assert len(coords["jax", False]) == len(coords["jax", True])
    assert not np.array_equal(coords["jax", False], coords["jax", True])  # the reference's fault
    _assert_items_equal(ds["port", False][0], ds["port", True][0], radar_bar=False)
    j_cached = ds["jax", True][0]
    j_cached["lidar_path"] = j_cached["lidar_path"].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    _assert_items_equal(ds["port", True][0], j_cached, radar_bar=False)
