"""``rald_torch.native`` (the ctypes bindings to ``native/rald_native.cpp``)
against JAX's numpy voxelizer and FPS and against scipy, as
``tests/test_native.py`` holds ``rald_tpu.native``; its fallbacks
(``RALD_NATIVE=0``) against the library; the dataset item through the
native voxelizer against the numpy one; and the port's host utilities
(``rald_torch.utils``), as ``tests/test_preprocess_cli.py`` holds JAX's.

Bars: voxelization, ``fps`` and the dataset item bitwise; ``nn_dists``
1e-6 relative of scipy's cKDTree; ``chamfer`` 1e-6 relative of the
reference formula, 1e-4 of the port's own exact Chamfer.
"""
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test worker)
from rald_torch import native

VOX_ARGS = ([0.5, 0.5, 0.5], [0, -15, -5, 15, 15, 5], 10, 5000)


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.build():
        pytest.skip("g++ unavailable: native library not built")
    assert native.available()


def _voxel_points(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    return rng.uniform([-1, -16, -6], [16, 16, 6], size=(n, 3)).astype(np.float32)


def _assert_grids_equal(a, b):
    for k in ("voxels", "coords", "num_points", "grid_size"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_library_lives_under_build_not_the_jax_package():
    assert native._lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "rald_native")
    assert "rald_tpu" not in str(native._lib_path())


def test_voxelize_matches_the_numpy_voxelizers():
    from rald_tpu.data.voxelizer import voxelize as j_voxelize

    from rald_torch.data.voxelizer import voxelize as np_voxelize

    pts = _voxel_points()
    got = native.voxelize(pts, *VOX_ARGS)
    assert len(got.coords) > 100
    _assert_grids_equal(got, np_voxelize(pts, *VOX_ARGS))
    _assert_grids_equal(got, j_voxelize(pts, *VOX_ARGS))


def test_voxelize_caps_and_drop_order():
    pts = np.zeros((100, 3), np.float32) + 0.25  # all in one voxel
    g = native.voxelize(pts, [0.5, 0.5, 0.5], [0, 0, 0, 1, 1, 1], 10, 50)
    assert len(g.coords) == 1 and g.num_points[0] == 10
    # 5 distinct voxels in scan order, cap at 3 -> the first 3 kept
    pts = np.array([[i + 0.5, 0.5, 0.5] for i in range(5)], np.float32)
    g = native.voxelize(pts, [1, 1, 1], [0, 0, 0, 5, 1, 1], 4, 3)
    np.testing.assert_array_equal(g.coords[:, 2], [0, 1, 2])


def test_nn_dists_and_chamfer_match_scipy():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(1)
    a = rng.normal(size=(500, 3)).astype(np.float32)
    b = rng.normal(size=(700, 3)).astype(np.float32)
    got = native.nn_dists(a, b)
    want, _ = cKDTree(b).query(a)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6)
    d_ba, _ = cKDTree(a).query(b)
    cd = native.chamfer(a, b)
    assert cd == pytest.approx(0.5 * want.mean() + 0.5 * d_ba.mean(), rel=1e-6)
    assert native.chamfer(np.zeros((0, 3)), np.ones((5, 3))) == float("inf")


def test_chamfer_matches_the_ports_exact_chamfer():
    from rald_torch.eval.chamfer import chamfer_distance

    rng = np.random.default_rng(3)
    a = rng.normal(size=(200, 3)).astype(np.float32)
    b = rng.normal(size=(350, 3)).astype(np.float32)
    assert native.chamfer(a, b) == pytest.approx(chamfer_distance(a, b, device="cpu"), rel=1e-4)


def test_fps_matches_the_ports_fps_and_jax():
    import torch

    from rald_tpu.ops.fps import farthest_point_sampling as j_fps

    from rald_torch.ops.fps import farthest_point_sampling

    pts = np.random.default_rng(4).normal(size=(256, 3)).astype(np.float32)
    got = native.fps(pts, 32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, farthest_point_sampling(torch.from_numpy(pts), 32).numpy())
    np.testing.assert_array_equal(got, np.asarray(j_fps(pts, 32)))


def test_opt_out_falls_back_to_the_ports_own_versions(monkeypatch):
    """``RALD_NATIVE=0`` (read at every call) serves the numpy / plain
    PyTorch versions, with the library's results."""
    pts = _voxel_points(5)
    rng = np.random.default_rng(6)
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = rng.normal(size=(200, 3)).astype(np.float32)
    lib = (native.voxelize(pts, *VOX_ARGS), native.nn_dists(a, b), native.chamfer(a, b),
           native.fps(a, 16, 3))
    monkeypatch.setenv("RALD_NATIVE", "0")
    assert not native.available()
    _assert_grids_equal(native.voxelize(pts, *VOX_ARGS), lib[0])
    np.testing.assert_allclose(native.nn_dists(a, b), lib[1], rtol=1e-6)
    assert native.chamfer(a, b) == pytest.approx(lib[2], rel=1e-5)
    fb = native.fps(a, 16, 3)
    assert fb.dtype == np.int32
    np.testing.assert_array_equal(fb, lib[3])
    monkeypatch.delenv("RALD_NATIVE")
    assert native.available()


def test_dataset_item_is_bitwise_with_and_without_the_library(tmp_path, monkeypatch):
    """The ColoRadar dataset (``cache_voxel: false``) voxelizes through
    ``rald_torch.native.voxelize``: the item is the same with the library
    and with ``RALD_NATIVE=0``."""
    from rald_torch.data.coloradar import ColoRadarDataset
    from rald_torch.data.synthetic import make_synthetic_coloradar, synthetic_dataset_config

    make_synthetic_coloradar(tmp_path, num_train_seqs=1, num_eval_seqs=1, frames_per_seq=2,
                             points_per_frame=3000, seed=7)
    cfg = synthetic_dataset_config(tmp_path)
    assert not cfg.lidar.cache_voxel
    calls = []
    real = native.voxelize
    monkeypatch.setattr("rald_torch.data.coloradar.voxelize",
                        lambda *a: calls.append(1) or real(*a))
    for loader in ("train", "test"):
        with_lib = ColoRadarDataset(tmp_path, cfg, loader_type=loader)[1]
        monkeypatch.setenv("RALD_NATIVE", "0")
        without = ColoRadarDataset(tmp_path, cfg, loader_type=loader)[1]
        monkeypatch.delenv("RALD_NATIVE")
        assert sorted(with_lib) == sorted(without)
        for k, v in with_lib.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == without[k].dtype
                np.testing.assert_array_equal(v, without[k], err_msg=k)
    assert len(calls) == 4


def test_thread_map_imap_and_async_pool():
    from rald_torch.utils import AsyncWorkerPool, imap_tqdm, thread_map

    assert imap_tqdm(lambda x: x * 2, [1, 2, 3], processes=1) == [2, 4, 6]
    assert thread_map(lambda x: x + 1, range(40), workers=8) == list(range(1, 41))
    with AsyncWorkerPool(2) as pool:
        futs = [pool.submit(lambda i=i: i * i) for i in range(4)]
    assert [f.result() for f in futs] == [0, 1, 4, 9]


def test_imap_tqdm_spawns_worker_processes():
    from rald_torch.utils import imap_tqdm

    assert imap_tqdm(abs, [-1, -2, 3], processes=2) == [1, 2, 3]


def test_shell_cmd():
    from rald_torch.utils import shell_cmd

    assert shell_cmd("echo hi").strip() == "hi"
    assert shell_cmd(["echo", "a b"]).strip() == "a b"


def test_interp_pose_matches_jax():
    from scipy.spatial.transform import Rotation

    from rald_tpu.utils.interpolate import interp_pose as j_interp
    from rald_torch.utils import interp_pose

    t = np.array([0.0, 1.0, 3.0])
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[1, :3, :3] = Rotation.from_euler("z", 90, degrees=True).as_matrix()
    poses[1, :3, 3] = [2.0, 0.0, 0.0]
    poses[2, :3, 3] = [2.0, 4.0, 1.0]
    target = np.array([-1.0, 0.5, 2.0, 5.0])
    out = interp_pose(poses, t, target)
    np.testing.assert_array_equal(out, j_interp(poses, t, target))
    np.testing.assert_allclose(out[1, :3, 3], [1.0, 0.0, 0.0], atol=1e-9)
    ang = Rotation.from_matrix(out[1, :3, :3]).as_euler("zyx", degrees=True)[0]
    assert abs(ang - 45.0) < 1e-6
    np.testing.assert_array_equal(out[0], poses[0])  # clipped to the source range


def test_geometry_host_helpers_are_bitwise_jax():
    from rald_tpu import geometry as jgeo

    from rald_torch import geometry as geo
    from rald_torch.constants import T_RADAR_TO_LIDAR

    rng = np.random.default_rng(8)
    pts = rng.uniform(-1.5, 1.5, size=(500, 3)).astype(np.float32)
    pts[:20] = 0.0
    np.testing.assert_array_equal(geo.remove_points_outside_fov(pts), jgeo.remove_points_outside_fov(pts))
    np.testing.assert_array_equal(geo.remove_empty_points(pts), jgeo.remove_empty_points(pts))
    polar = geo.cartesian2polar(10 * pts[20:])
    limits = [[0.0, 12.0], [-60.0, 60.0], [-20.0, 20.0]]
    np.testing.assert_array_equal(geo.filter_points_polar(polar, limits),
                                  jgeo.filter_points_polar(polar, limits))
    np.testing.assert_array_equal(geo.get_inverse_tf(T_RADAR_TO_LIDAR),
                                  jgeo.get_inverse_tf(T_RADAR_TO_LIDAR))
    np.testing.assert_allclose(geo.get_inverse_tf(T_RADAR_TO_LIDAR) @ T_RADAR_TO_LIDAR,
                               np.eye(4), atol=1e-12)
    mask = rng.random(500) > 0.5
    np.testing.assert_array_equal(geo.compact_points(pts, mask), jgeo.compact_points(pts, mask))
