"""The port's host data pipeline (``rald_torch/data``, ``rald_torch/constants.py``)
and the eval loop's host helpers (``rald_torch/train/{metrics,profiler}.py``),
bitwise against ``rald_tpu``: the synthetic trees file by file,
``ColoRadarDataset`` / ``HUSTRadarDataset`` items key by key, ``DataLoader``
batches and ``ShardedSampler`` shards, ``voxelize``, the query samplers and
``aug_query_helper`` on seeded inputs. The JAX side's ``voxelize`` is its C++
binding where built (``rald_tpu.native``), the port's the numpy version of
the same contract."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from rald_torch.config import Config as TConfig

RADAR_SHAPE = (32, 16, 16)


def _assert_same_tree(a, b):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _assert_same_item(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic ColoRadar tree written by both packages."""
    from rald_torch.data.synthetic import make_synthetic_coloradar as t_make
    from rald_tpu.data.synthetic import make_synthetic_coloradar as j_make

    root = tmp_path_factory.mktemp("coloradar")
    kw = dict(num_train_seqs=1, num_eval_seqs=1, frames_per_seq=2, points_per_frame=4000,
              radar_shape=RADAR_SHAPE, helper_points=300, seed=1)
    return j_make(root / "jax", **kw), t_make(root / "port", **kw)


def test_synthetic_coloradar_tree_is_bytewise_jax(trees):
    _assert_same_tree(*trees)


def test_synthetic_hustradar_tree_is_bytewise_jax(tmp_path):
    from rald_torch.data.synthetic import make_synthetic_hustradar as t_make
    from rald_tpu.data.synthetic import make_synthetic_hustradar as j_make

    kw = dict(frames_per_seq=2, points_per_frame=500, radar_shape=(8, 4, 2),
              highres_shape=(8, 4, 4), seed=3)
    _assert_same_tree(j_make(tmp_path / "jax", **kw), t_make(tmp_path / "port", **kw))


def test_constants_match_jax():
    import rald_torch.constants as t
    import rald_tpu.constants as j

    for name in ("C", "WAVELENGTH_TO_APERTURE_RATIO", "NUMBER_RECORDING_ATTRIBUTES",
                 "T_BASE_TO_RADAR", "T_BASE_TO_LIDAR", "T_RADAR_TO_LIDAR",
                 "HUST_T_LIDAR_TO_SINGLE_CHIP", "HUST_T_SINGLE_CHIP_TO_LIDAR", "HUST_DIR_NAMES"):
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)))


def _ds_configs(root, view_cone=True, **updates):
    """The same dataset config for both packages (the tiny test shapes)."""
    from rald_tpu.data.synthetic import synthetic_dataset_config

    d = synthetic_dataset_config(root, view_cone=view_cone).to_dict()
    d["radar"].update(input_r_dim=32, input_a_dim=16, input_e_dim=16, upsample=False)
    d["lidar"]["num_samples"] = 512
    for k, v in updates.items():
        if isinstance(v, dict):
            d[k].update(v)
        else:
            d[k] = v
    from rald_tpu.config import Config as JConfig

    return JConfig(d), TConfig(json.loads(json.dumps(d)))


HELPER = dict(use_query_helper=True, query_helper_aug=True, query_aug_num=256, query_aug_scale=2)


@pytest.mark.parametrize("view_cone", [True, False])
@pytest.mark.parametrize("helper_on_device", [False, True])
@pytest.mark.parametrize("sampling", [True, False])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_coloradar_items_are_bitwise_jax(trees, mode, sampling, helper_on_device, view_cone):
    """Every key of every item, for each split, with sampling on and off
    (bucket-padded raw counts + masks), CFAR helpers densified on the host
    or shipped raw for the device, view cone on and off, points shuffled."""
    from rald_torch.data.coloradar import ColoRadarDataset as TD
    from rald_tpu.data.coloradar import ColoRadarDataset as JD

    root = trees[0]
    jc, tc = _ds_configs(root, view_cone, helper_aug_on_device=helper_on_device,
                         lidar={"sampling": sampling, "shuffle_pts": True}, **HELPER)
    jd, td = JD(root, jc, loader_type=mode, seed=5), TD(root, tc, loader_type=mode, seed=5)
    assert len(td) == len(jd) == 2
    assert td.radar_path_list == jd.radar_path_list
    for epoch in (0, 3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for i in range(len(jd)):
            _assert_same_item(td[i], jd[i])
    item = td[0]
    if not sampling:
        assert item["lidar_points"].shape == (8192, 3) and item["lidar_mask"].sum() < 8192
    if mode == "test":
        assert ("helper_mask" in item) == helper_on_device


def test_coloradar_cached_and_predicted_latents_are_bitwise_jax(trees, tmp_path):
    """``use_cache_latent`` (.npz caches) and ``use_pred_latent`` (.npy and
    reference .pt latents) load the same arrays, and the toggles work."""
    from rald_torch.data.coloradar import ColoRadarDataset as TD
    from rald_tpu.data.coloradar import ColoRadarDataset as JD

    root = trees[0]
    split = json.loads((root / "split_synth.json").read_text())
    rng = np.random.default_rng(0)
    for seq in split["train"]:
        d = tmp_path / "cache" / "sub" / seq
        d.mkdir(parents=True)
        for f in sorted((root / seq / "lidar_sc").glob("*.bin")):
            np.savez(d / (f.name + ".npz"), res_tokens=rng.normal(size=(16, 8)).astype(np.float32))
    for seq in split["test"]:
        d = tmp_path / "pred" / "sub" / seq / "latent_tokens"
        d.mkdir(parents=True)
        np.save(d / "0000.npy", rng.normal(size=(16, 8)).astype(np.float32))
        torch.save(torch.from_numpy(rng.normal(size=(1, 16, 8)).astype(np.float32)), d / "0001.pt")
    jc, tc = _ds_configs(root, use_cache_latent=True,
                         cache_latent_base_dir=str(tmp_path / "cache"), cache_latent_sub_dir="sub",
                         use_pred_latent=True, pred_latent_base_dir=str(tmp_path / "pred"),
                         pred_latent_sub_dir="sub")
    for mode in ("train", "test"):
        if mode == "test":
            jc.use_cache_latent = tc.use_cache_latent = False
        jd, td = JD(root, jc, loader_type=mode), TD(root, tc, loader_type=mode)
        for i in range(len(jd)):
            _assert_same_item(td[i], jd[i])
    assert td[1]["pred_latent"].shape == (1, 16, 8)
    td.set_load_query(False)
    td.set_load_radar(False)
    jd.set_load_query(False)
    jd.set_load_radar(False)
    _assert_same_item(td[0], jd[0])
    assert "query_points" not in td[0] and "radar_cube" not in td[0]


def test_hustradar_items_are_bitwise_jax(tmp_path):
    """``HUSTRadarDataset`` over a ``make_synthetic_hustradar`` tree: numeric
    sort of the ``rae_map`` stems (12 frames, so 10 sorts after 9), the
    ``.npy`` cubes, and the registry's dispatch."""
    from rald_torch.data.registry import get_dataset as t_get
    from rald_torch.data.synthetic import make_synthetic_hustradar
    from rald_tpu.data.registry import get_dataset as j_get

    root = make_synthetic_hustradar(tmp_path, frames_per_seq=12, points_per_frame=300,
                                    radar_shape=(32, 16, 16), highres_shape=(8, 4, 4), seed=2)
    seq = "classroom_f404_20241219_0"
    (root / seq / "lidar_sc").mkdir()
    for i, f in enumerate(sorted((root / seq / "lidar").glob("*.bin"))[:12]):
        scan = np.fromfile(f, np.float32).reshape(-1, 4)[:, :3]
        scan = scan[np.linalg.norm(scan, axis=1) > 0]  # the raw scans' zero returns
        np.ascontiguousarray(scan).tofile(root / seq / "lidar_sc" / f"{i:04d}.bin")
    (root / "split.json").write_text(json.dumps({"train": [seq], "val": [], "test": []}))
    jc, tc = _ds_configs(root, split_file="split.json", dataset_name="HUSTRadarDataset")
    jd, td = j_get(jc, "train", seed=1), t_get(tc, "train", seed=1)
    assert type(td).__name__ == "HUSTRadarDataset"
    assert td.radar_path_list[10].stem == "10" and td.radar_path_list == jd.radar_path_list
    for i in (0, 2, 10, 11):
        _assert_same_item(td[i], jd[i])
    tc.dataset_name = "Nope"
    with pytest.raises(ValueError, match="Invalid dataset"):
        t_get(tc, "train")


@pytest.mark.parametrize("drop_last,pad_last,bsz", [(False, True, 2), (True, False, 2),
                                                     (False, False, 3), (False, True, 4)])
def test_loader_batches_are_bitwise_jax(trees, drop_last, pad_last, bsz):
    """Batches of the threaded loader, element for element, over both
    splits with helpers (bucket-padded eval items; pad_last repeats the last
    frame; drop_last drops the ragged tail)."""
    from rald_torch.data.coloradar import ColoRadarDataset as TD
    from rald_torch.data.loader import DataLoader as TL
    from rald_tpu.data.coloradar import ColoRadarDataset as JD
    from rald_tpu.data.loader import DataLoader as JL

    root = trees[0]
    split = json.loads((root / "split_synth.json").read_text())
    (root / "split_all.json").write_text(json.dumps(
        {"train": [], "val": [], "test": split["train"] + split["val"] + split["test"]}))
    jc, tc = _ds_configs(root, split_file="split_all.json", helper_aug_on_device=True,
                         lidar={"sampling": False}, **HELPER)
    jl = JL(JD(root, jc, loader_type="test"), bsz, num_workers=2, drop_last=drop_last,
            pad_last=pad_last)
    tl = TL(TD(root, tc, loader_type="test"), bsz, num_workers=2, drop_last=drop_last,
            pad_last=pad_last)
    assert len(tl) == len(jl)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == len(jl)
    for t, j in zip(tb, jb):
        _assert_same_item(t, j)
    if pad_last and 6 % bsz:
        assert tb[-1]["lidar_path"][-1] == tb[-1]["lidar_path"][-2]


@pytest.mark.parametrize("n,replicas,shuffle,drop_last", [(10, 3, True, False), (10, 3, True, True),
                                                         (7, 2, False, False), (7, 4, False, True)])
def test_sharded_sampler_shards_match_jax(n, replicas, shuffle, drop_last):
    from rald_torch.data.loader import ShardedSampler as T
    from rald_tpu.data.loader import ShardedSampler as J

    for epoch in (0, 1):
        for rank in range(replicas):
            t, j = (cls(n, replicas, rank, shuffle=shuffle, seed=4, drop_last=drop_last)
                    for cls in (T, J))
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert len(t) == len(j) and list(t) == list(j)


def test_collate_pads_ragged_buckets_like_jax():
    from rald_torch.data.loader import collate as t_collate
    from rald_tpu.data.loader import collate as j_collate

    items = [{"a": np.ones((8192, 3), np.float32), "n": np.int32(3), "p": "x", "f": 1.5},
             {"a": np.full((16384, 3), 2, np.float32), "n": np.int32(4), "p": "y", "f": 2.5}]
    _assert_same_item(t_collate(items), j_collate(items))


class _Slow:
    """A dataset whose items take a while, or fail at one index."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad item {i}")
        time.sleep(0.01)
        return {"x": np.full((2,), i, np.float32)}


def test_loader_stops_its_threads_when_the_consumer_stops():
    """A consumer that breaks out early, or sees a worker's exception, leaves
    no producer thread behind (prefetch queue full, producer blocked)."""
    from rald_torch.data.loader import DataLoader

    before = threading.active_count()
    it = iter(DataLoader(_Slow(40), 2, num_workers=2, prefetch=1, drop_last=False))
    assert next(it)["x"].tolist() == [[0, 0], [1, 1]]
    time.sleep(0.1)  # let the producer fill the queue and block
    it.close()
    with pytest.raises(ValueError, match="bad item 5"):
        for _ in DataLoader(_Slow(12, fail_at=5), 2, num_workers=2, drop_last=False):
            pass
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.02)
    assert threading.active_count() <= before


def test_voxelize_is_bitwise_jax():
    from rald_torch.data.voxelizer import grid_size_of, voxelize as t_vox
    from rald_tpu.data.voxelizer import voxelize as j_np
    from rald_tpu.native import voxelize as j_native

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform([0, -90, -20], [15.8, 90, 20], (3000, 3)),
                          rng.uniform([0, -90, -20], [0.2, -89, -19.5], (200, 3)),  # crowded
                          rng.uniform(-100, 100, (100, 3))]).astype(np.float32)  # outliers
    pts = np.column_stack([pts, rng.uniform(size=len(pts))]).astype(np.float32)
    vs, pr = [0.05, 0.25, 0.5], [0, -90, -20, 15.8, 90, 20]
    for max_pts, max_vox in ((10, 50000), (3, 500)):
        got = t_vox(pts, vs, pr, max_pts, max_vox)
        for j in (j_np(pts, vs, pr, max_pts, max_vox), j_native(pts, vs, pr, max_pts, max_vox)):
            for f in ("voxels", "coords", "num_points", "grid_size"):
                np.testing.assert_array_equal(getattr(got, f), getattr(j, f), err_msg=f)
    assert grid_size_of(pr, vs).tolist() == [316, 720, 80]
    assert t_vox(np.full((4, 3), 99, np.float32), vs, pr, 10, 10).coords.shape == (0, 3)


@pytest.mark.parametrize("grid", [(316, 720, 80), (20, 20, 10)])  # rejection / dense branch
def test_query_samplers_are_bitwise_jax(grid):
    from rald_torch.data import query as tq
    from rald_tpu.data import query as jq

    rng = np.random.default_rng(1)
    vs, pr = [0.05, 0.25, 0.5], [0, -90, -20, 15.8, 90, 20]
    coords = np.stack([rng.integers(0, g, 400) for g in grid[::-1]], axis=1).astype(np.int32)
    for name, args in (("voxel_centers", (coords, vs, pr)),
                       ("empty_voxel_centers", (coords[:, ::-1], grid, 300, vs, pr)),
                       ("sample_train_queries", (coords, grid, vs, pr, 40, 600)),
                       ("sample_eval_queries", (coords, vs, pr, 640))):
        kw = {} if name == "voxel_centers" else {"rng": None}
        t_out = getattr(tq, name)(*args, **{k: np.random.default_rng(7) for k in kw})
        j_out = getattr(jq, name)(*args, **{k: np.random.default_rng(7) for k in kw})
        for t, j in zip(*(o if isinstance(o, tuple) else (o,) for o in (t_out, j_out))):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("n,aug_num,scale", [(37, 500, 2), (600, 500, 2), (5, 2000, 10)])
def test_aug_query_helper_is_bitwise_jax(n, aug_num, scale):
    from rald_torch.data.query import aug_query_helper as t_aug
    from rald_tpu.data.query import aug_query_helper as j_aug

    pts = np.random.default_rng(2).uniform([0, -90, -20], [15.8, 90, 20], (n, 3)).astype(np.float32)
    args = (pts, aug_num, [0, -90, -20, 15.8, 90, 20], [0.05, 0.25, 0.5], scale)
    t_rng, j_rng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):  # the stream continues alike
        np.testing.assert_array_equal(t_aug(*args, rng=t_rng), j_aug(*args, rng=j_rng))


def test_bucket_helpers_match_jax():
    from rald_torch.data import bucket as tb
    from rald_tpu.data import bucket as jb

    assert tb.DEFAULT_EVAL_BUCKETS == jb.DEFAULT_EVAL_BUCKETS
    for n in (1, 8192, 8193, 70000):
        assert tb.pick_bucket(n, tb.DEFAULT_EVAL_BUCKETS) == jb.pick_bucket(n, jb.DEFAULT_EVAL_BUCKETS)
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    for size in (4, 16):
        for t, j in zip(tb.pad_axis0(a, size, 7.0), jb.pad_axis0(a, size, 7.0)):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)


def test_metric_logger_matches_jax(tmp_path):
    """Meters, averages and the ``log_every`` lines of the two loggers agree
    (timings aside); the JSONL sink appends records; TensorBoard is a no-op
    without ``log_dir``; a disabled StageTimer records nothing."""
    from rald_torch.train.metrics import JsonlLogger, MetricLogger, TensorBoardLogger
    from rald_torch.train.profiler import StageTimer
    from rald_tpu.train.metrics import MetricLogger as JLogger

    t_lines, j_lines = [], []
    loggers = (MetricLogger(print_fn=t_lines.append), JLogger(print_fn=j_lines.append))
    for lg in loggers:
        for i, _ in enumerate(lg.log_every(range(5), 2, "Test:")):
            lg.update(loss=0.5 * i, iou=1.0 / (i + 1))
    assert loggers[0].averages() == loggers[1].averages()
    assert str(loggers[0]) == str(loggers[1])
    def untimed(lines):
        return [l.split(" eta")[0].split(" Total time")[0] for l in lines]

    assert untimed(t_lines) == untimed(j_lines)
    assert len(t_lines) == 4 and t_lines[-1].startswith("Test: Total time")

    jl = JsonlLogger(tmp_path / "logs")
    jl.write({"epoch": 0})
    jl.write({"epoch": 1})
    assert [json.loads(l) for l in (tmp_path / "logs" / "log.txt").read_text().splitlines()] == [
        {"epoch": 0}, {"epoch": 1}]
    tb = TensorBoardLogger(None)
    tb.add_scalar("loss", 1.0, 0)
    tb.flush()
    assert tb.writer is None

    off = StageTimer(enabled=False)
    with off("a"):
        pass
    assert off.report() == {} and off.block(torch.ones(2)) is not None
    on = StageTimer()
    for _ in range(2):
        with on("a"):
            time.sleep(0.01)
    with on("b"):
        pass
    assert list(on.report()) == ["a", "b"] and on.counts == {"a": 2, "b": 1}
