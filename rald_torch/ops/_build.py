"""Build the CUDA kernels under ``rald_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/rald_torch_kernels/``
(listed in ``.gitignore``) and loaded with ``ctypes``. The library's file
name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a built one is reused.
Nothing here runs at import time.

:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them; ``chip_smoke.py`` calls it so the builds overlap.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rald_torch_kernels"
SOURCES = ("geglu", "nn_dist", "geglu_int8", "attn", "qk_norm", "moe_ffn", "head_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory / spill report of each build, by source,
# with any advisory that wgmma instructions were serialized, and each
# nvcc's wall time in seconds
ptxas_report: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("rald_torch: nvcc not found (CUDA toolkit needed to build the kernels)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (tmp, proc, time.perf_counter())


def _finish(name: str, job, logs: dict) -> None:
    """Wait for one ``nvcc``; its log into ``logs``, its wall time into
    ``build_seconds``."""
    _, proc, t0 = job
    logs[name], _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0


def build_all(names=SOURCES) -> None:
    """Compile every missing kernel library, all ``nvcc`` runs in parallel.

    Every started ``nvcc`` is waited for before a failure is raised."""
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        logs: dict = {}
        waits = [threading.Thread(target=_finish, args=(n, job, logs))
                 for n, (_, job) in jobs.items() if job is not None]
        for t in waits:
            t.start()
        for t in waits:
            t.join()
        for n, (out, job) in jobs.items():
            if job is None:
                continue
            tmp, proc, _ = job
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"rald_torch: nvcc failed for csrc/{n}.cu:\n{logs[n]}")
            ptxas_report[n] = "\n".join(
                l for l in logs[n].splitlines()
                if any(k in l for k in ("entry function", "registers", "spill", "wgmma",
                                        "Performance"))
            )
            os.replace(tmp, out)
        for n, (out, _) in jobs.items():
            _libs[n] = ctypes.CDLL(str(out))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"rald_torch: {what} launch failed with cudaError {rc}")
