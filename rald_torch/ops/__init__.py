"""Hand-written CUDA kernels (``rald_torch/csrc``) and their plain versions.

Each kernel wrapper counts its own launches in ``<wrapper>.launches``; the
plain version (CPU tensors) never counts.
"""
from __future__ import annotations

from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual
from rald_torch.ops.nn_dist_kernel import nn_min_sq_both

KERNELS = {
    "fused_ln_geglu_residual": fused_ln_geglu_residual,
    "nn_min_sq_both": nn_min_sq_both,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
