"""The traced run's readings: a ``torch.profiler`` over a bounded number of
steps (summaries kept in memory, no Chrome trace written), the device's
busy time (the union of its kernels' intervals), the device time of the
kernels launched inside a host range the harness opens around an op's
public wrapper (correlation of each kernel with the host op that launched
it), the top device ops and the longest idle gaps by what the host was
doing."""
from __future__ import annotations

import contextlib
import math
import sys

import torch

RANGE = "bench::"


def _kernels(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize(prof, ops: tuple) -> dict:
    """``busy_s``, ``window_s`` (first to last host event of the profiled
    steps), ``kernels``, the device seconds of each op range
    (``op_calls[op]``: one entry per call, in call order), and the
    ``breakdown`` lists."""
    events = list(prof.events())
    kern = _kernels(events)
    cpu = [e for e in events if e.device_type.name == "CPU"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end, gaps = 0.0, -math.inf, []
    for a, b in spans:
        if a > end and end > -math.inf:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    starts = [e.time_range.start for e in cpu] + [s[0] for s in spans]
    ends = [e.time_range.end for e in cpu] + [s[1] for s in spans]
    window = (max(ends) - min(starts)) if starts else 0.0
    front = [e for e in cpu if not getattr(e, "is_async", False)]
    op_calls, attributed = _op_kernel_seconds(front, kern, ops)
    by_name = {}
    for k in kern:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.time_range.end - k.time_range.start) * 1e-6
    return {
        "busy_s": busy * 1e-6, "window_s": window * 1e-6, "kernels": len(kern),
        "op_calls": op_calls, "attributed_kernels": attributed,
        "breakdown": {
            "device_ops": [[n[:120], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": _gaps_by_host(gaps, front),
        },
    }


def _op_kernel_seconds(front, kern, ops) -> tuple:
    """Device seconds of the kernels launched inside each op range, one
    entry per range in call order. A kernel belongs to the range that was
    open on the launching thread when its launch call (the runtime event
    with the kernel's correlation id) was made."""
    import bisect

    launches = {e.id: e for e in front if "aunch" in e.name}
    ranges = {}  # thread -> sorted [(start, end, op, index)]
    op_calls = {op: [] for op in ops}
    for e in sorted(front, key=lambda e: e.time_range.start):
        op = e.name[len(RANGE):] if e.name.startswith(RANGE) else None
        if op in op_calls:
            ranges.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end, op,
                                                    len(op_calls[op])))
            op_calls[op].append(0.0)
    starts = {t: [r[0] for r in rs] for t, rs in ranges.items()}
    attributed = 0
    for k in kern:
        launch = launches.get(k.id)
        if launch is None or launch.thread not in ranges:
            continue
        i = bisect.bisect_right(starts[launch.thread], launch.time_range.start) - 1
        if i >= 0:
            s0, e0, op, n = ranges[launch.thread][i]
            if launch.time_range.start <= e0:
                op_calls[op][n] += (k.time_range.end - k.time_range.start) * 1e-6
                attributed += 1
    return op_calls, attributed


def _gaps_by_host(gaps, front) -> list:
    """Idle device time, summed by the innermost host op of the launching
    thread running at the start of each gap (the top 10)."""
    threads = {}
    for e in front:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    if not threads:
        return []
    main = max(threads, key=threads.get)
    evs = sorted((e for e in front if e.thread == main), key=lambda e: e.time_range.start)
    total, stack, i = {}, [], 0
    for a, b in sorted(gaps):
        while i < len(evs) and evs[i].time_range.start <= a:
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].time_range.end < a:
            stack.pop()
        name = stack[-1].name if stack else "host (no op)"
        total[name] = total.get(name, 0.0) + (b - a) * 1e-6
    return [[n[:120], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:10]]


class OpRanges:
    """Host ranges around the public wrappers of ``ops`` wherever the
    system's modules bound them (``rald_torch.ops.KERNELS`` names the
    wrappers), and per call the reader's ``describe`` of its arguments,
    while :attr:`recording` is on."""

    def __init__(self, readers: dict):
        from rald_torch.ops import KERNELS

        self.calls = {op: [] for op in readers}
        self.recording = False
        self._saved = []
        for op, reader in readers.items():
            original = KERNELS[op]
            wrapper = self._wrap(op, original, reader)
            for name, mod in list(sys.modules.items()):
                if (name.startswith("rald_torch.") and not name.startswith("rald_torch.ops")
                        and getattr(mod, op, None) is original):
                    self._saved.append((mod, op, original))
                    setattr(mod, op, wrapper)

    def _wrap(self, op, fn, reader):
        tag = RANGE + op

        def wrapper(*args, **kwargs):
            if not self.recording:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(tag):
                out = fn(*args, **kwargs)
            self.calls[op].append(reader.describe(args, kwargs, out))
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def restore(self) -> None:
        for mod, op, fn in self._saved:
            setattr(mod, op, fn)
        self._saved = []


@contextlib.contextmanager
def profiled():
    """A CPU + CUDA profiler over the block; nothing is written to disk."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
