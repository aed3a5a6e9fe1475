"""Parallel-map helpers for host-side preprocessing: the port's own copy of
``rald_tpu/utils/concurrent.py``.

Capability parity with reference ``utils/concurrent.py``:
``imap_tqdm`` ordered parallel map (:147-180), ``AsyncWorkerPool``
(:54-121), ``shell_cmd`` (:21-52).

The preprocessing CLIs batch frames through PyTorch on the card, so the
process pool serves only pure-CPU work; :func:`thread_map` is preferred
where the worker releases the GIL (numpy IO, CUDA launches and copies). A
process that holds a CUDA context must not fork, so the pool spawns.
"""
from __future__ import annotations

import multiprocessing as mp
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Sequence


def _progress(iterable, total=None, desc=None, enabled=True):
    if not enabled:
        yield from iterable
        return
    try:
        from tqdm import tqdm

        yield from tqdm(iterable, total=total, desc=desc)
    except ImportError:
        for i, item in enumerate(iterable):
            if total and (i % max(1, total // 20) == 0):
                print(f"{desc or 'progress'}: {i}/{total}")
            yield item


def imap_tqdm(
    fn: Callable,
    items: Sequence,
    processes: int = 4,
    desc: str | None = None,
    method: str = "spawn",
) -> list:
    """Ordered parallel map with a progress bar (reference :147-180).

    ``processes <= 1`` runs inline.
    """
    items = list(items)
    if processes <= 1 or len(items) <= 1:
        return [fn(it) for it in _progress(items, total=len(items), desc=desc)]
    ctx = mp.get_context(method)
    with ctx.Pool(processes=processes) as pool:
        return list(_progress(pool.imap(fn, items), total=len(items), desc=desc))


def thread_map(fn: Callable, items: Sequence, workers: int = 8, desc: str | None = None) -> list:
    """Ordered thread map — for GIL-releasing work (file IO, device dispatch)."""
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(it) for it in _progress(items, total=len(items), desc=desc)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(_progress(pool.map(fn, items), total=len(items), desc=desc))


class AsyncWorkerPool:
    """Submit tasks eagerly, collect results later (reference :54-121)."""

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []

    def submit(self, fn: Callable, *args, **kwargs):
        fut = self._pool.submit(fn, *args, **kwargs)
        self._futures.append(fut)
        return fut

    def join(self) -> list:
        results = [f.result() for f in self._futures]
        self._futures.clear()
        return results

    def shutdown(self):
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.join()
        self.shutdown()


def shell_cmd(cmd: str | Iterable[str], check: bool = True, capture: bool = True) -> str:
    """Run a shell command, return stdout (reference :21-52)."""
    if isinstance(cmd, str):
        result = subprocess.run(cmd, shell=True, check=check, capture_output=capture, text=True)
    else:
        result = subprocess.run(list(cmd), check=check, capture_output=capture, text=True)
    return result.stdout if capture else ""
