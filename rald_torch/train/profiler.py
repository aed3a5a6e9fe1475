"""Profiling hooks and stage timing (``rald_tpu/train/profiler.py``).

- :func:`maybe_trace` (:33-42): a ``torch.profiler`` trace of the enclosed
  region when a profile dir is configured (``RALD_PROFILE_DIR``, else
  ``system.profile_dir``; :func:`profile_dir_from`, :23-30), written as a
  Chrome trace (``chrome://tracing``, Perfetto); CPU activity, and CUDA
  activity when a card is in use;
- :func:`annotate` (:45-47): a named region inside such a trace;
- :func:`span`: the program's own ``rald::<name>`` ranges, on the
  profiler's clock while a profiler runs, and each span's host
  milliseconds while an engine times a step (``timings``); nothing
  otherwise;
- :class:`StageTimer` (:49-89): accumulated wall time per stage of a
  host-driven loop; :func:`synced_ms` is the engines' synchronised stage
  split of a step. The per-iteration iter/data timers live in
  :class:`rald_torch.train.metrics.MetricLogger.log_every`.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "rald::"
# the context of a span that neither a profiler nor a timed stage sees
NO_SPAN = contextlib.nullcontext()
# the ``timings`` dict of the engine stage (:func:`synced_ms`) the host is in
_STAGE_TIMINGS: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "rald_stage_timings", default=None)


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


class _HostMs:
    """Adds the block's host milliseconds to ``timings[key]``."""

    __slots__ = ("timings", "key", "t0")

    def __init__(self, timings: dict, key: str):
        self.timings, self.key = timings, key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        self.timings[self.key] = self.timings.get(self.key, 0.0) + ms
        return False


def span(name: str):
    """The program's span ``name``: under a running profiler a
    ``record_function("rald::" + name)`` range (host side only: it adds no
    synchronise); inside a stage an engine times (:func:`synced_ms` with a
    ``timings`` dict) the span's host milliseconds, added to
    ``timings[name + ".host"]``; otherwise :data:`NO_SPAN`, which costs one
    flag read and one context-variable read. A name holds no ``aunch`` and
    does not start with ``bench::``: the benchmark's trace reader keys the
    runtime's launch events and its own op ranges on those."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    timings = _STAGE_TIMINGS.get()
    if timings is None:
        return NO_SPAN
    return _HostMs(timings, name + ".host")


class StageTimer:
    """Accumulating wall-clock attribution for a host-driven loop.

    ``with st("stage"): ...`` adds the block's wall time to that stage's
    bucket and opens the stage's :func:`span`; :meth:`report` returns
    ``{stage: seconds}``. When ``enabled`` is False only the span remains
    (nothing unless a profiler runs), so the instrumented code path costs
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
        t0 = time.perf_counter() if self.enabled else None
        try:
            with span(stage):
                yield
        finally:
            if t0 is not None:
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
    """An engine's stage ``name``, always the :func:`span` ``name``. With a
    ``timings`` dict: the block's wall milliseconds, the CUDA ``device``
    synchronised before and after, added to ``timings[name]``; its host
    milliseconds, from the same start until the block returns (before the
    closing synchronise), to ``timings[name + ".host"]``; and the spans
    nested in the block add theirs to the same dict. A host time near the
    synced time means the host paces the stage."""
    if timings is None:
        with span(name):
            yield
        return
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda *_: None)
    sync(device)
    t0 = time.perf_counter()
    prof_range = (torch.profiler.record_function(SPAN_PREFIX + name)
                  if _autograd_profiler._is_profiler_enabled else NO_SPAN)
    token = _STAGE_TIMINGS.set(timings)
    try:
        with prof_range:
            yield
    finally:
        _STAGE_TIMINGS.reset(token)
    t1 = time.perf_counter()
    sync(device)
    t2 = time.perf_counter()
    timings[name] = timings.get(name, 0.0) + (t2 - t0) * 1e3
    timings[name + ".host"] = timings.get(name + ".host", 0.0) + (t1 - t0) * 1e3
