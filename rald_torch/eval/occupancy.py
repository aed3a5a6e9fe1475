"""Occupancy IoU / accuracy at logit threshold 0 (``rald_tpu/eval/occupancy.py``)."""
from __future__ import annotations

import torch


def occupancy_metrics(logits, labels, threshold: float = 0.0, mask=None) -> dict:
    """Per-batch mean IoU and accuracy. ``logits``/``labels``: (B, Q);
    ``mask`` (B, Q) marks valid queries — padded entries count nothing."""
    pred = (logits >= threshold).float()
    labels = labels.float()
    if mask is None:
        accuracy = ((pred == labels).float().sum(1) / labels.shape[1]).mean()
        intersection = (pred * labels).sum(1)
        union = ((pred + labels) > 0).float().sum(1) + 1e-5
    else:
        mask = mask.float()
        valid = mask.sum(1) + 1e-5
        accuracy = (((pred == labels).float() * mask).sum(1) / valid).mean()
        intersection = (pred * labels * mask).sum(1)
        union = (((pred + labels) > 0).float() * mask).sum(1) + 1e-5
    return {"iou": (intersection / union).mean(), "accuracy": accuracy}
