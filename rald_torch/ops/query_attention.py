"""Chunked map over a huge query axis (``rald_tpu/ops/query_attention.py:43``)
and the single-head attention core streamed over it (:67-87).

The decoder scores up to ~1.2M query points per frame against a few
hundred latent tokens; queries are independent, so the query axis is
streamed in chunks with O(chunk) live memory. The JAX attention core is
plain XLA (no Pallas kernel), and so is this one: two matmuls around an f32
softmax.
"""
from __future__ import annotations

from typing import Callable

import torch


def map_query_chunks(
    fn: Callable[[torch.Tensor], torch.Tensor],
    queries: torch.Tensor,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """Apply ``fn`` ((B, chunk, F) -> (B, chunk, ...)) over chunks of the
    query axis of ``queries`` (B, Q, F) and reassemble (B, Q, ...)."""
    q = queries.shape[1]
    if q <= chunk_size:
        return fn(queries)
    return torch.cat(
        [fn(queries[:, s:s + chunk_size]) for s in range(0, q, chunk_size)], dim=1
    )


def streaming_single_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float | None = None,
    chunk_size: int = 65536,
) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` of (B, Q, D) queries over small (B, M, D)
    keys / values (``scale`` defaults to D^-0.5), the softmax in f32 and
    cast back to ``v``'s dtype, the query axis streamed in ``chunk_size``
    blocks."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale

    def attend(q_blk):
        sim = torch.einsum("bqd,bmd->bqm", q_blk, k) * scale
        attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
        return torch.einsum("bqm,bmd->bqd", attn, v)

    return map_query_chunks(attend, q, chunk_size)
