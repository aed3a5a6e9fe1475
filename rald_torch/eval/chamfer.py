"""Exact Chamfer distance + F-score (``rald_tpu/eval/chamfer.py:157-229``).

Nearest-neighbour distances come from
:func:`rald_torch.ops.nn_dist_kernel.nn_min_sq_both` (the CUDA kernel on the
card, its exact subtract-square plain version on the CPU): never
``|a|^2+|b|^2-2ab``, never ``torch.cdist``'s matmul mode, never TF32 —
cancellation around zero distances corrupted CD/F that way
(docs/DESIGN.md:56-79).

Empty predictions keep the reference semantics: CD inf, F-score 0.
"""
from __future__ import annotations

import numpy as np
import torch

from rald_torch import resolve_device
from rald_torch.ops.nn_dist_kernel import BIG, nn_min_sq_both


def batched_cd_fscore_graph(pred, pred_mask, gt, gt_mask, tau: float):
    """(B, P, 3)/(B, P) + (B, G, 3)/(B, G) -> ((B,) Chamfer, (B,) F-score)."""
    pred_valid = torch.where(pred_mask[..., None], pred.float(), BIG).contiguous()
    gt_valid = torch.where(gt_mask[..., None], gt.float(), BIG).contiguous()
    d2_pg, d2_gp = nn_min_sq_both(pred_valid, gt_valid)
    d_pg = torch.sqrt(torch.clamp(d2_pg, min=0.0))
    d_gp = torch.sqrt(torch.clamp(d2_gp, min=0.0))
    pm = pred_mask.float()
    gm = gt_mask.float()
    n_pred = torch.clamp(pm.sum(1), min=1.0)
    n_gt = torch.clamp(gm.sum(1), min=1.0)
    cd = 0.5 * (d_pg * pm).sum(1) / n_pred + 0.5 * (d_gp * gm).sum(1) / n_gt
    precision = ((d_pg < tau).float() * pm).sum(1) / n_pred
    recall = ((d_gp < tau).float() * gm).sum(1) / n_gt
    denom = precision + recall
    f = torch.where(denom > 0, 2 * precision * recall / torch.where(denom > 0, denom, 1.0), 0.0)
    empty = pm.sum(1) == 0
    return torch.where(empty, float("inf"), cd), torch.where(empty, 0.0, f)


def chamfer_and_fscore_batch(preds: list, gts: list, tau: float, device=None) -> tuple:
    """Host API: per-frame (Chamfer, F-score@tau) for ragged clouds, padded
    to shared power-of-two caps and computed in one batched call."""
    dev = resolve_device(device)
    preds = [np.asarray(p, np.float32).reshape(-1, 3) for p in preds]
    gts = [np.asarray(g, np.float32).reshape(-1, 3) for g in gts]
    bsz = len(preds)
    cap_p = max(8, 1 << (max(max(len(p) for p in preds), 1) - 1).bit_length())
    cap_g = max(8, 1 << (max(max(len(g) for g in gts), 1) - 1).bit_length())
    pred_pad = np.full((bsz, cap_p, 3), BIG, np.float32)
    gt_pad = np.full((bsz, cap_g, 3), BIG, np.float32)
    pmask = np.zeros((bsz, cap_p), bool)
    gmask = np.zeros((bsz, cap_g), bool)
    for i, (p, g) in enumerate(zip(preds, gts)):
        pred_pad[i, :len(p)] = p
        gt_pad[i, :len(g)] = g
        pmask[i, :len(p)] = True
        gmask[i, :len(g)] = True
    t = lambda a: torch.from_numpy(a).to(dev)
    cd, f = batched_cd_fscore_graph(t(pred_pad), t(pmask), t(gt_pad), t(gmask), tau)
    return cd.cpu().tolist(), f.cpu().tolist()
