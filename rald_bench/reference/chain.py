"""The reference's eval chain and training steps, on the weights and inputs
the benchmark made, in float32 (TF32 off).

Eval (:func:`run_chain`): condition tokens from the raw cube, the
35-evaluation Heun sample from the benchmark's prior draw, the decode of
the eval queries (loss, IoU, accuracy), of the grid and the densified CFAR
helpers, the refine pass, the predicted point count and Chamfer / F. To
judge the program it runs stage by stage from the program's own stage
outputs, as a served model's tokens are read to judge what follows them;
each stage is then compared on its own. The device draws (grid, densify,
refine) come from the generator the benchmark gave the program, seeded
again, in the program's order.

Training (:func:`train_steps`): VAE encode, EDM loss, gradients, global-norm
clip, AdamW from a given update count, for the first steps of a cell.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rald_bench.reference.nets import EDMDenoiser, VecSetVAE, edm_loss, heun_sample


def _pc(pc_range, dev):
    pc = torch.as_tensor(np.asarray(pc_range, np.float32), device=dev)
    return (pc[3:6] + pc[:3]) / 2, (pc[3:6] - pc[:3]) / 2


def norm_points(p, pc_range):
    off, sc = _pc(pc_range, p.device)
    return (p - off) / sc


def inverse_norm_points(p, pc_range):
    off, sc = _pc(pc_range, p.device)
    return p * sc + off


def polar2cartesian(p):
    """(range, azimuth [deg], elevation [deg]) -> (x, y, z); azimuth is
    negated, as the dataset stores it."""
    r, az, el = p[..., 0], -torch.deg2rad(p[..., 1]), torch.deg2rad(p[..., 2])
    return torch.stack([r * torch.cos(el) * torch.cos(az), r * torch.cos(el) * torch.sin(az),
                        r * torch.sin(el)], -1)


def densify(points, mask, k, gen, pc_range, voxel_size, max_scale, low: bool = False):
    """(B, N, 3) normalized candidates with (B, N) validity -> (B, k, 3)
    and (B, k) validity: slot s < n is the s-th valid point; a later slot
    is a uniformly picked valid point jittered by U[-1, 1)^3 * voxel *
    U{1..max_scale} in metric space and clipped to the range. Draws, in
    order: pick (B, k), jitter (B, k, 3), scale (B, k). ``low``: the
    coordinates in bfloat16 (the control)."""
    bsz, n_in = mask.shape
    dev = points.device
    n = mask.sum(1)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)  # valid first, in order
    u_pick = torch.rand((bsz, k), generator=gen, device=dev)
    u = torch.rand((bsz, k, 3), generator=gen, device=dev) * 2.0 - 1.0
    scale = torch.randint(1, max_scale + 1, (bsz, k), generator=gen, device=dev).float()
    s = torch.arange(k, device=dev)[None]
    orig = s < n[:, None]
    bound = n.clamp(max=k).clamp(min=1)[:, None]
    pick = torch.minimum((u_pick * bound.float()).long(), bound - 1)
    idx = torch.gather(order, 1, torch.where(orig, s, pick).clamp(max=n_in - 1))
    pos = _low(inverse_norm_points(torch.gather(points.float(), 1, idx[..., None].expand(bsz, k, 3)),
                                   pc_range), low)
    lo, hi = (torch.as_tensor(np.asarray(pc_range, np.float32)[a:b], device=dev)
              for a, b in ((0, 3), (3, 6)))
    vs = torch.as_tensor(np.asarray(voxel_size, np.float32), device=dev)
    aug = _low(torch.minimum(torch.maximum(pos + u * vs * scale[..., None], lo), hi), low)
    out = torch.where(orig[..., None], pos, aug)
    return _low(norm_points(out, pc_range), low), (n > 0)[:, None].expand(bsz, k)


def _tf32(x):
    """``x`` rounded to TF32 (a 10-bit mantissa), in float32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def nn_min_sq(a, b, chunk=2048, low: bool = False):
    """(Na, 3) x (Nb, 3) -> (Na,) least squared distance to ``b``, by exact
    subtract-square in float32; ``low``: the |a|^2 + |b|^2 - 2 a.b form
    with the product's inputs rounded to TF32 (the control)."""
    if low:
        ta, tb = _tf32(a), _tf32(b)
        return torch.cat([((a[s:s + chunk] ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None]
                           - 2 * ta[s:s + chunk] @ tb.T).min(1).values
                          for s in range(0, a.shape[0], chunk)])
    return torch.cat([((a[s:s + chunk, None, :] - b[None]) ** 2).sum(-1).min(1).values
                      for s in range(0, a.shape[0], chunk)])


def chamfer_f(pred, gt, tau, low: bool = False):
    """Chamfer distance (half the sum of the two mean NN distances) and
    F-score at ``tau``; an empty prediction gives (inf, 0)."""
    if len(pred) == 0:
        return float("inf"), 0.0
    d_pg = nn_min_sq(pred, gt, low=low).clamp_min(0).sqrt()
    d_gp = nn_min_sq(gt, pred, low=low).clamp_min(0).sqrt()
    cd = 0.5 * d_pg.mean() + 0.5 * d_gp.mean()
    p, r = (d_pg < tau).float().mean(), (d_gp < tau).float().mean()
    f = 2 * p * r / (p + r) if p + r > 0 else torch.zeros(())
    return float(cd), float(f)


def occupancy(logits, labels):
    """BCE loss, IoU and accuracy at threshold 0 over (B, Q) queries."""
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    pred = (logits >= 0).float()
    acc = (pred == labels).float().mean(1).mean()
    iou = ((pred * labels).sum(1) / (((pred + labels) > 0).float().sum(1) + 1e-5)).mean()
    return float(loss), float(iou), float(acc)


class BatchMismatch(ValueError):
    """A judged record whose tensors do not hold one row per frame."""


@torch.no_grad()
def run_chain(dit: EDMDenoiser, vae: VecSetVAE, inputs: dict, ev: dict, gen, forced=None,
              low: bool = False) -> dict:
    """The eval chain on one batch of the benchmark's ``inputs``; ``gen``
    is a fresh generator seeded as the program's step generator was.

    With ``forced`` (the program's record of the batch: condition tokens,
    latents, decoded query sets and their logits) every stage starts from
    the program's output of the stage before it: the sampler from its
    tokens, the decodes from its latents at its query sets, the refine
    densify from its grid hits, Chamfer / F from its predicted cloud. The
    grid and helper queries and the refine densify are still drawn here,
    to be compared with the program's. ``low``: the control's lower
    precision where the models' matmuls do not reach (query arithmetic in
    bfloat16, distances in the TF32 matmul form)."""
    dev = ev["device"]
    f = forced or {}
    bsz = len(inputs["radar_cube"])
    if any(torch.is_tensor(v) and v.dim() and v.shape[0] != bsz for v in f.values()):
        raise BatchMismatch(f"the judged record does not hold the batch's {bsz} frames")

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    out = {"cond": dit.condition(t(inputs["radar_cube"]))}
    cond = f["cond"].to(dev).float() if f else out["cond"]
    out["latents"] = heun_sample(dit, cond, t(inputs["prior"]), **ev["sampler"])
    h = vae.decode_latents(f["latents"].to(dev).float() if f else out["latents"])
    out["logits"] = vae.decode_queries(h, t(inputs["q_eval"]))
    out["loss"], out["iou"], out["acc"] = occupancy(out["logits"], t(inputs["labels"]))
    grid = torch.rand((ev["num_query"], 3), generator=gen, device=dev) * 2.0 - 1.0
    helper, _ = densify(t(inputs["helper"]), t(inputs["helper_mask"], torch.bool),
                        ev["helper_num"], gen, ev["pc_range"], ev["voxel_size"], ev["helper_scale"],
                        low)
    out["q_grid"] = torch.cat([grid[None].expand(bsz, -1, -1), helper], 1)
    del helper
    q_grid = f["q_grid"].to(dev).float() if f else _low(out["q_grid"], low)
    out["l_grid"] = vae.decode_queries(h, q_grid)
    hits = (f["l_grid"].to(dev) if f else out["l_grid"]) > 0
    out["q_ref"], valid = densify(q_grid, hits, ev["refine_num"], gen, ev["pc_range"],
                                  ev["voxel_size"], ev["refine_scale"], low)
    del hits
    q_ref = f["q_ref"].to(dev).float() if f else out["q_ref"]
    out["l_ref"] = vae.decode_queries(h, q_ref)
    mask = ((f["l_ref"].to(dev) if f else out["l_ref"]) > 0) & valid
    out["n_pred"] = mask.sum(1).tolist()
    out["cd"], out["f"] = [], []
    surf = t(inputs["surface"])
    for i in range(bsz):
        pred = polar2cartesian(inverse_norm_points(q_ref[i][mask[i]], ev["pc_range"]))
        gt = polar2cartesian(inverse_norm_points(surf[i], ev["pc_range"]))
        cd, fs = chamfer_f(pred, gt, ev["fscore_tau"], low)
        out["cd"].append(cd)
        out["f"].append(fs)
    return out


def _low(x, low: bool):
    return x.to(torch.bfloat16).float() if low else x


def lr_at(count: int, tr: dict) -> float:
    """Linear warmup over ``warmup_epochs``, then a half cosine from ``lr``
    to ``min_lr`` at ``epochs``; ``count`` is the update count."""
    epoch = count / tr["steps_per_epoch"]
    if epoch < tr["warmup_epochs"]:
        return tr["lr"] * epoch / tr["warmup_epochs"]
    span = max(tr["epochs"] - tr["warmup_epochs"], 1e-8)
    cos = 0.5 * (1.0 + np.cos(np.pi * (epoch - tr["warmup_epochs"]) / span))
    return tr["min_lr"] + (tr["lr"] - tr["min_lr"]) * cos


def train_steps(dit: EDMDenoiser, vae: VecSetVAE, batches: list, tr: dict, half: bool = False):
    """The first ``len(batches)`` steps from the weights in ``dit``: VAE
    encode (``eps``), EDM loss (``rnd``, ``noise``), gradients, global-norm
    clip to ``clip_grad``, AdamW (0.9, 0.999, 1e-8, decay 0.01) with zero
    moments at update ``tr["count"]``. ``half``: the loss is the mean over
    the first half of each batch (a planted fault). Returns the losses,
    each leaf's first gradient norm as the optimizer gets it (clipped), and
    each leaf's change norm after the steps."""
    params = dict(dit.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    for p in params.values():
        opt.state[p] = {"step": torch.tensor(float(tr["count"])), "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
    losses, first = [], None
    for i, b in enumerate(batches):
        if half:
            n = b["radar_cube"].shape[0] // 2
            b = {k: v[:n] for k, v in b.items()}
        with torch.no_grad():
            y = vae.encode(b["lidar_points"], b["eps"])
        loss = edm_loss(dit, y, b["radar_cube"], b["rnd"], b["noise"])
        grads = torch.autograd.grad(loss, list(params.values()))
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if not norm < tr["clip_grad"]:
            grads = [g / norm * tr["clip_grad"] for g in grads]
        if first is None:
            first = {k: g.norm().item() for k, g in zip(params, grads)}
        for p, g in zip(params.values(), grads):
            p.grad = g
        opt.param_groups[0]["lr"] = lr_at(tr["count"] + i, tr)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    change = {k: (p.detach() - start[k]).norm().item() for k, p in params.items()}
    return losses, first, change
