"""Exact Chamfer distance + F-score (``rald_tpu/eval/chamfer.py``).

The batched graph the engine's eval step runs (:157-229) takes both
directions from one :func:`~rald_torch.ops.nn_dist_kernel.nn_min_sq_both`
sweep; the host APIs (:33-154: :func:`nearest_neighbor_dists`,
:func:`masked_chamfer_fscore`, :func:`masked_chamfer`,
:func:`chamfer_distance`, :func:`chamfer_and_fscore`) run one
:func:`~rald_torch.ops.nn_dist_kernel.nn_min_sq_batch` per direction. Each
is the CUDA kernel on the card and its exact subtract-square plain version
on the CPU: never ``|a|^2+|b|^2-2ab`` (JAX's host APIs use that matmul
form), never ``torch.cdist``'s matmul mode, never TF32 — cancellation
around zero distances corrupted CD/F that way (docs/DESIGN.md:56-79).

Empty predictions keep the reference semantics: CD inf, F-score 0.
"""
from __future__ import annotations

import numpy as np
import torch

from rald_torch import resolve_device
from rald_torch.ops.nn_dist_kernel import BIG, nn_min_sq_batch, nn_min_sq_both


def _tensor(a, device=None) -> torch.Tensor:
    """A tensor stays where it lies; numpy goes to ``device`` (the card by
    default)."""
    if torch.is_tensor(a):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve_device(device))


def nearest_neighbor_dists(a, b, device=None) -> torch.Tensor:
    """For each point of ``a`` (N, 3): the euclidean distance to the
    nearest point of ``b`` (M, 3). Rows of ``b`` carrying ``BIG`` never win;
    padded ``a`` rows give garbage the caller masks."""
    a = _tensor(a, device).float().contiguous()
    b = _tensor(b, device).to(a.device).float().contiguous()
    return torch.sqrt(torch.clamp(nn_min_sq_batch(a[None], b[None])[0], min=0.0))


def masked_chamfer_fscore(pred, pred_mask, gt, gt_mask, tau: float):
    """Chamfer + F-score@tau of one padded pair, ``(pred (P, 3), mask (P,))``
    and ``(gt (G, 3), mask (G,))``, from one nearest-neighbour pass each
    way: 0-d tensors (CD inf and F 0 for an empty prediction)."""
    pred_valid = torch.where(pred_mask[:, None], pred.float(), BIG)
    gt_valid = torch.where(gt_mask[:, None], gt.float(), BIG)
    d_pg = nearest_neighbor_dists(pred, gt_valid)
    d_gp = nearest_neighbor_dists(gt, pred_valid)
    pm, gm = pred_mask.float(), gt_mask.float()
    n_pred = torch.clamp(pm.sum(), min=1.0)
    n_gt = torch.clamp(gm.sum(), min=1.0)
    cd = 0.5 * (d_pg * pm).sum() / n_pred + 0.5 * (d_gp * gm).sum() / n_gt
    precision = ((d_pg < tau).float() * pm).sum() / n_pred
    recall = ((d_gp < tau).float() * gm).sum() / n_gt
    denom = precision + recall
    f = torch.where(denom > 0, 2 * precision * recall / torch.where(denom > 0, denom, 1.0), 0.0)
    empty = pm.sum() == 0
    return torch.where(empty, float("inf"), cd), torch.where(empty, 0.0, f)


def masked_chamfer(pred, pred_mask, gt, gt_mask):
    """The Chamfer half of :func:`masked_chamfer_fscore`."""
    return masked_chamfer_fscore(pred, pred_mask, gt, gt_mask, 1.0)[0]


def _pad_pow2(pred: np.ndarray, gt: np.ndarray, device):
    """Both clouds padded with ``BIG`` rows to power-of-two caps (>= 8),
    with their masks, as tensors on ``device``."""
    out = []
    for pts in (pred, gt):
        cap = max(8, 1 << (len(pts) - 1).bit_length())
        pad = np.full((cap, 3), BIG, np.float32)
        pad[:len(pts)] = pts
        out += [pad, np.arange(cap) < len(pts)]
    return [torch.from_numpy(a).to(device) for a in out]


def chamfer_distance(pred, gt, device=None) -> float:
    """Host API (reference ``cal_metrics``, utils/utils.py:116-137)."""
    return chamfer_and_fscore(pred, gt, 1.0, device)[0]


def chamfer_and_fscore(pred, gt, tau: float, device=None) -> tuple:
    """Host API: (Chamfer, F-score@tau) of two ragged clouds."""
    pred = np.asarray(pred, np.float32).reshape(-1, 3)
    gt = np.asarray(gt, np.float32).reshape(-1, 3)
    dev = resolve_device(device)
    if len(pred) == 0:
        return float("inf"), 0.0
    cd, f = masked_chamfer_fscore(*_pad_pow2(pred, gt, dev), tau)
    return float(cd), float(f)


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
