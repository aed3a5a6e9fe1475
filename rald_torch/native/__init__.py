"""ctypes bindings for the first-party C++ host ops (``native/rald_native.cpp``):
the port of ``rald_tpu/native/__init__.py``.

These serve the host side of the pipeline, replacing the reference's
third-party native wheels (SURVEY.md §2b): spconv voxelization, scipy
cKDTree Chamfer, torch_cluster fps. They are host ops, not device kernels.

The library is compiled with ``g++`` at first use (never at import) into
``build/rald_native/`` at the repository root, under a name that carries a
hash of the source, so an edited source is rebuilt. ``available()`` reports
whether it loaded. Every public function falls back to the port's own
numpy / plain PyTorch version when the library cannot be built, and when
``RALD_NATIVE=0`` (read at every call).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "rald_native.cpp"
BUILD_DIR = _REPO / "build" / "rald_native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librald_native_{digest}.so"


def build() -> bool:
    """Compile the shared library with g++ unless it is built; returns
    success. The output is written under a temporary name and renamed, so
    concurrent builds never load a half-written file."""
    out = _lib_path()
    if out.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, text=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if os.environ.get("RALD_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_lib_path()))
        except OSError:
            _load_failed = True
            return None

        i64, f32p = ctypes.c_int64, np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.rald_voxelize.restype = i64
        lib.rald_voxelize.argtypes = [f32p, i64, i64, f64p, f64p, i64, i64, f32p, i32p, i32p]
        lib.rald_nn_dists.restype = None
        lib.rald_nn_dists.argtypes = [f32p, i64, f32p, i64, f32p, ctypes.c_void_p]
        lib.rald_chamfer.restype = ctypes.c_double
        lib.rald_chamfer.argtypes = [f32p, i64, f32p, i64]
        lib.rald_fps.restype = None
        lib.rald_fps.argtypes = [f32p, i64, i64, i64, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def voxelize(points, voxel_size, pc_range, max_points_per_voxel: int, max_voxels: int):
    """Native first-come voxelization; the contract of
    :func:`rald_torch.data.voxelizer.voxelize` (its fallback)."""
    from rald_torch.data.voxelizer import VoxelGrid, grid_size_of
    from rald_torch.data.voxelizer import voxelize as np_voxelize

    lib = _load()
    if lib is None:
        return np_voxelize(points, voxel_size, pc_range, max_points_per_voxel, max_voxels)

    points = np.ascontiguousarray(points, np.float32)
    n, c = points.shape
    vs = np.ascontiguousarray(voxel_size, np.float64)
    pr = np.ascontiguousarray(pc_range, np.float64)
    out_voxels = np.zeros((max_voxels, max_points_per_voxel, c), np.float32)
    out_coords = np.zeros((max_voxels, 3), np.int32)
    out_num = np.zeros((max_voxels,), np.int32)
    n_vox = lib.rald_voxelize(
        points, n, c, vs, pr, max_points_per_voxel, max_voxels,
        out_voxels, out_coords, out_num,
    )
    return VoxelGrid(
        voxels=out_voxels[:n_vox],
        coords=out_coords[:n_vox],
        num_points=out_num[:n_vox],
        grid_size=grid_size_of(pc_range, voxel_size),
    )


def nn_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact euclidean NN distance from each point of ``a`` to set ``b``."""
    lib = _load()
    a = np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1, 3))
    b = np.ascontiguousarray(np.asarray(b, np.float32).reshape(-1, 3))
    if lib is None:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.sqrt(d2.min(axis=1)).astype(np.float32)
    out = np.empty((len(a),), np.float32)
    lib.rald_nn_dists(a, len(a), b, len(b), out, None)
    return out


def chamfer(pred: np.ndarray, gt: np.ndarray) -> float:
    """Symmetric Chamfer (reference utils/utils.py:116-142 semantics)."""
    lib = _load()
    pred = np.ascontiguousarray(np.asarray(pred, np.float32).reshape(-1, 3))
    gt = np.ascontiguousarray(np.asarray(gt, np.float32).reshape(-1, 3))
    if len(pred) == 0:
        return float("inf")
    if lib is None:
        from rald_torch.eval.chamfer import chamfer_distance

        return chamfer_distance(pred, gt, device="cpu")
    return float(lib.rald_chamfer(pred, len(pred), gt, len(gt)))


def fps(points: np.ndarray, num_samples: int, start_idx: int = 0) -> np.ndarray:
    """Farthest point sampling indices (int32) on the host."""
    lib = _load()
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    if lib is None:
        import torch

        from rald_torch.ops.fps import farthest_point_sampling

        idx = farthest_point_sampling(torch.from_numpy(points), num_samples, start_idx)
        return idx.numpy().astype(np.int32)
    out = np.empty((num_samples,), np.int32)
    lib.rald_fps(points, len(points), num_samples, start_idx, out)
    return out
