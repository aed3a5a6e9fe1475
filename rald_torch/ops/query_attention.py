"""Chunked map over a huge query axis (``rald_tpu/ops/query_attention.py:43``).

The decoder scores up to ~1.2M query points per frame against a few
hundred latent tokens; queries are independent, so the query axis is
streamed in chunks with O(chunk) live memory.
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
