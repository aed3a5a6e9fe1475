"""Profiling hooks and stage timing (``rald_tpu/train/profiler.py``).

- :func:`maybe_trace` (:33-42): a ``torch.profiler`` trace of the enclosed
  region when a profile dir is configured (``RALD_PROFILE_DIR``, else
  ``system.profile_dir``; :func:`profile_dir_from`, :23-30), written as a
  Chrome trace (``chrome://tracing``, Perfetto); CPU activity, and CUDA
  activity when a card is in use;
- :func:`annotate` (:45-47): a named region inside such a trace;
- :class:`StageTimer` (:49-89): accumulated wall time per stage of a
  host-driven loop; :func:`synced_ms` is the engines' synchronised stage
  split of a step. The per-iteration iter/data timers live in
  :class:`rald_torch.train.metrics.MetricLogger.log_every`.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Optional

import torch


def profile_dir_from(cfg=None) -> Optional[str]:
    """``RALD_PROFILE_DIR`` if set, else ``system.profile_dir`` of ``cfg``."""
    env = os.environ.get("RALD_PROFILE_DIR")
    if env:
        return env
    if cfg is not None:
        return cfg.get("system", {}).get("profile_dir")
    return None


@contextlib.contextmanager
def maybe_trace(cfg=None, profile_dir: Optional[str] = None):
    """Trace the enclosed region iff a profile dir is configured
    (``profile_dir``, else :func:`profile_dir_from` of ``cfg``): a
    ``torch.profiler.profile`` of the CPU, plus CUDA when a card is
    available, written on exit as ``trace_<pid>_<n>.json`` in the dir. The
    profiler yields itself (None when not tracing)."""
    d = profile_dir or profile_dir_from(cfg)
    if not d:
        yield None
        return
    os.makedirs(d, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len(list(Path(d).glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(Path(d) / f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """A named sub-region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulating wall-clock attribution for a host-driven loop.

    ``with st("stage"): ...`` adds the block's wall time to that stage's
    bucket; :meth:`report` returns ``{stage: seconds}``. When ``enabled`` is
    False every operation is a no-op, so the instrumented code path costs
    nothing in production. :meth:`block` synchronises the CUDA device a
    result lies on, so asynchronous kernel work is charged to the stage
    that launched it (profiling only: it serializes the host/device overlap
    it measures).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.seconds: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
            self.counts[stage] = self.counts.get(stage, 0) + 1

    def block(self, value):
        """Synchronise the CUDA device of ``value`` (a tensor or a tuple of
        them) iff profiling; returns ``value`` either way."""
        if self.enabled:
            for t in value if isinstance(value, (tuple, list)) else (value,):
                if torch.is_tensor(t) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
                    break
        return value

    def report(self) -> dict:
        return dict(sorted(self.seconds.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def synced_ms(timings, name: str, device):
    """Add the block's wall milliseconds to ``timings[name]``, the CUDA
    ``device`` synchronised before and after; a no-op when ``timings`` is
    None."""
    if timings is None:
        yield
        return
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda *_: None)
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
