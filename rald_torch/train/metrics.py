"""Metric logging: windowed meters, ETA-reporting iterator, JSONL + TB sinks;
the port's own copy of ``rald_tpu/train/metrics.py``.

Capability parity with ``utils/misc.py:21-164`` (``SmoothedValue``,
``MetricLogger.log_every``) and the per-epoch JSON-lines ``log.txt``
(``main_ae.py:186-190``). The port runs one process on one card, so
``synchronize_between_processes`` is a no-op kept for API familiarity, as
in the JAX package. The peak device memory of ``log_every`` is
``torch.cuda.max_memory_allocated`` where JAX reads ``memory_stats``.
"""
from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterable, Optional

import torch


class SmoothedValue:
    """Track a window of values + global average (misc.py:21-80)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        pass  # one process: nothing to reduce

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def averages(self) -> dict:
        return {k: m.global_avg for k, m in self.meters.items()}

    @staticmethod
    def _device_mem() -> str:
        """Peak CUDA memory, as the reference's max-mem display
        (misc.py:126-158). Empty without a card."""
        if torch.cuda.is_available():
            peak = torch.cuda.max_memory_allocated()
            if peak:
                return f" mem: {peak / 2**20:.0f}MB"
        return ""

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        """Iterator wrapper printing iter/data timing + ETA (misc.py:120-164)."""
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                mem = self._device_mem()
                if total is not None:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    self.print(
                        f"{header} [{i}/{total}] eta: {eta} {self} "
                        f"time: {iter_time} data: {data_time}{mem}"
                    )
                else:
                    self.print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}{mem}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        per_it = elapsed / max(i, 1)
        self.print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} ({per_it:.4f} s / it)")


class JsonlLogger:
    """Per-epoch JSON-lines log (reference log.txt, main_ae.py:186-190)."""

    def __init__(self, log_dir: str | Path, filename: str = "log.txt", enabled: bool = True):
        self.enabled = enabled
        if enabled:
            self.path = Path(log_dir) / filename
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: dict):
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


class TensorBoardLogger:
    """Scalar sink on the reference's epoch_1000x axis (engine_ae.py:137-149).

    A no-op without ``log_dir``, and when TensorBoard's writer cannot be
    imported (the JSONL log is the durable sink).
    """

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self.writer = None
        if not (enabled and log_dir):
            return
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self.writer = SummaryWriter(log_dir=str(log_dir))
        except Exception:
            self.writer = None

    def add_scalar(self, tag: str, value, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


def epoch_1000x(epoch_fraction: float) -> int:
    """TensorBoard x-axis calibration (engine_ae.py:141)."""
    return int(epoch_fraction * 1000)
