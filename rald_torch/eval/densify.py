"""On-device query densification (``rald_tpu/eval/densify.py:34-87``).

Same construction and distribution as the JAX function, on a
``torch.Generator`` (so not the same draws):

  slot s < n:  the s-th valid input point, verbatim (no jitter, no clip);
  slot s >= n: a uniformly picked valid point + U[-1,1)^3 * voxel_size *
               scale jitter (scale ~ uniform int in [1, aug_bias_scale]),
               clipped to pc_range, all in un-normalized metric space.

Valid inputs need not be contiguous; "the s-th valid point" follows input
order. A frame with no valid input is marked invalid.
"""
from __future__ import annotations

import numpy as np
import torch

from rald_torch import geometry as geo
from rald_torch.parallel.dist import draw_rows


def densify_queries(points_norm, mask, k: int, generator: torch.Generator, pc_range,
                    voxel_size, aug_bias_scale: int, anisotropic: bool, isotropic: bool):
    """(B, N, 3) normalized candidates + (B, N) validity -> (B, k, 3)
    normalized queries, (B, k) slot validity, (B,) valid-input counts.
    Under a process group the draws are this rank's rows of draws at the
    global batch (:func:`rald_torch.parallel.draw_rows`)."""
    bsz, n_in = mask.shape
    dev = points_norm.device
    mask = mask.bool()
    c = torch.cumsum(mask.int(), dim=1)
    n = c[:, -1]
    # rank of each valid input among the valid ones; the rest go to sink k
    rank = torch.where(mask, torch.clamp(c - 1, max=k), torch.full_like(c, k)).long()
    src = torch.arange(n_in, device=dev).expand(bsz, n_in)
    slot_of_rank = torch.zeros((bsz, k + 1), dtype=torch.long, device=dev)
    slot_of_rank.scatter_(1, rank, src)
    slot_of_rank = slot_of_rank[:, :k]

    s = torch.arange(k, device=dev)[None]
    bound = torch.clamp(torch.clamp(n, max=k), min=1)[:, None].float()
    u_pick = draw_rows(torch.rand, (bsz, k), generator=generator, device=dev)
    pick = torch.minimum((u_pick * bound).long(), bound.long() - 1)
    is_orig = s < n[:, None]
    rsel = torch.where(is_orig, torch.clamp(s, max=k - 1), pick)
    idx = torch.gather(slot_of_rank, 1, rsel)
    pos = torch.gather(points_norm.float(), 1, idx[..., None].expand(bsz, k, 3))

    pc = np.asarray(pc_range, np.float32)
    vs = torch.as_tensor(np.asarray(voxel_size, np.float32), device=dev)
    pos_un = geo.inverse_norm_points(pos, pc, anisotropic, isotropic)
    u = draw_rows(torch.rand, (bsz, k, 3), generator=generator, device=dev) * 2.0 - 1.0
    scale = draw_rows(lambda shape, **kw: torch.randint(1, aug_bias_scale + 1, shape, **kw),
                      (bsz, k), generator=generator, device=dev).float()
    aug = pos_un + u * vs * scale[..., None]
    aug = torch.clamp(aug, torch.as_tensor(pc[:3], device=dev), torch.as_tensor(pc[3:6], device=dev))
    out_un = torch.where(is_orig[..., None], pos_un, aug)
    out = geo.norm_points(out_un, pc, anisotropic, isotropic)
    valid = (n > 0)[:, None].expand(bsz, k)
    return out.float(), valid, n
