"""Hand-written CUDA kernels (``rald_torch/csrc``) and their plain versions.

Each kernel wrapper counts its own launches in ``<wrapper>.launches``; the
plain version (CPU tensors) never counts. ``streaming_single_head_attention``
is exported beside them, as ``rald_tpu.ops`` exports it: plain PyTorch, no
kernel, so it is not in :data:`KERNELS`.
"""
from __future__ import annotations

from rald_torch.ops.attn_kernel import (
    fused_self_attention_block,
    fused_self_attention_block_int8,
    fused_self_attention_block_int8_vout,
)
from rald_torch.ops.geglu_kernel import (
    fused_ln_geglu_residual,
    fused_ln_geglu_residual_int8,
    fused_ln_geglu_residual_int8_static,
    geglu_ff,
)
from rald_torch.ops.head_norm import head_rms_norm
from rald_torch.ops.moe_ffn import moe_grouped_ffn
from rald_torch.ops.nn_dist_kernel import nn_min_sq_batch, nn_min_sq_both
from rald_torch.ops.qk_norm import split_qk_norm
from rald_torch.ops.query_attention import streaming_single_head_attention

KERNELS = {
    "fused_ln_geglu_residual": fused_ln_geglu_residual,
    "nn_min_sq_both": nn_min_sq_both,
    "nn_min_sq_batch": nn_min_sq_batch,
    "fused_ln_geglu_residual_int8": fused_ln_geglu_residual_int8,
    "fused_ln_geglu_residual_int8_static": fused_ln_geglu_residual_int8_static,
    "geglu_ff": geglu_ff,
    "fused_self_attention_block": fused_self_attention_block,
    "fused_self_attention_block_int8": fused_self_attention_block_int8,
    "fused_self_attention_block_int8_vout": fused_self_attention_block_int8_vout,
    "split_qk_norm": split_qk_norm,
    "moe_grouped_ffn": moe_grouped_ffn,
    "head_rms_norm": head_rms_norm,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
