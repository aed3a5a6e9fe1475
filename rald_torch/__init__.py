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


# jax_default_matmul_precision values -> torch.set_float32_matmul_precision
_MATMUL_PRECISION = {
    "highest": "highest", "float32": "highest",
    "high": "high", "tensorfloat32": "high", "bfloat16_3x": "high",
    "default": "medium", "bfloat16": "medium", "fastest": "medium",
}


def apply_matmul_precision(value) -> str:
    """What ``jax.config.update("jax_default_matmul_precision", value)`` is
    to JAX, for PyTorch: sets ``torch.set_float32_matmul_precision`` and
    ``torch.backends.cudnn.allow_tf32`` (f32 convolutions, such as the
    radar encoder's ``Conv3d``) for the whole process.

    - ``highest`` / ``float32`` -> ``"highest"``, cuDNN TF32 off;
    - ``high`` / ``tensorfloat32`` / ``bfloat16_3x`` -> ``"high"``, TF32 on;
    - ``default`` / ``bfloat16`` / ``fastest`` -> ``"medium"``, TF32 on;
    - anything else raises ``ValueError``.

    A lower setting grants PyTorch leave to compute f32 products in less
    precision; it does not require it. The port's own f32 kernels compute
    exact f32 products under every setting. Returns the torch setting."""
    key = str(value).lower()
    if key not in _MATMUL_PRECISION:
        raise ValueError(
            f"matmul_precision must be one of {sorted(_MATMUL_PRECISION)}, got {value!r}"
        )
    torch_value = _MATMUL_PRECISION[key]
    torch.set_float32_matmul_precision(torch_value)
    torch.backends.cudnn.allow_tf32 = torch_value != "highest"
    return torch_value


def precision_in_force() -> dict:
    """The torch switches that decide f32 matmul and convolution precision,
    as they stand in this process (what :func:`apply_matmul_precision`
    sets, or torch's defaults)."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "cuda_matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}
