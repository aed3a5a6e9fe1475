"""RaLD in PyTorch + hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``rald_tpu`` (JAX/Pallas), held numerically against it by the
``tests/test_torch_*.py`` parity tests. Importing the package imports
``torch`` only: the CUDA kernels under ``rald_torch/csrc`` are compiled at
their first launch (:mod:`rald_torch.ops._build`), never at import.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    ``None`` means ``"cuda"``; a CUDA device with no card present raises
    instead of silently running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rald_torch: no CUDA device available; pass device='cpu' to run "
            "on the CPU explicitly"
        )
    return dev
