"""Stage timing for host-driven loops: the port's ``StageTimer``
(``rald_tpu/train/profiler.py:49-89``).

The per-iteration iter/data timers live in
:class:`rald_torch.train.metrics.MetricLogger.log_every`; :func:`synced_ms`
is the engines' synchronised stage split of a step.
"""
from __future__ import annotations

import contextlib
import time

import torch


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
