"""Render a convergence run's curves page from its two JSONL logs: the port
of ``scripts/render_curves.py``.

    python -m rald_torch.cli.render_curves <stage1 log.txt> <stage2 log.txt> \
        [--reference <stage1 log> <stage2 log>] [--device "<name>, <power limit>"] > CURVES_H100.md

The same sparklines and tables from the same keys as the JAX script (every
``val_*`` line: stage 1 ``val_iou`` / ``val_loss``, stage 2 ``val_iou`` /
``val_cd`` / ``val_loss``, every other stage-2 eval point in the table,
the best and the final stage-2 point). The header names the card and its
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (``--device`` replaces it where there is
no card), and the closing section reads the run's own half-way and final
eval points instead of the JAX run's prose. With ``--reference`` (the JAX
run's two logs, ``docs/artifacts/curves_stage{1,2}_log.jsonl``) it adds a
table of the run's values beside the reference logs' at the epochs both
evaluated.
"""
from __future__ import annotations

import argparse
import json
import subprocess


def rows(path) -> list:
    """The log's lines that hold an evaluation (a ``val_*`` key)."""
    out = []
    for line in open(path):
        d = json.loads(line)
        if any(k.startswith("val_") for k in d):
            out.append(d)
    return out


def spark(values, lo=None, hi=None, invert=False) -> str:
    blocks = "▁▂▃▄▅▆▇█"
    vals = [v for v in values if v == v and v != float("inf")]
    if not vals:
        return ""
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    span = (hi - lo) or 1.0
    s = ""
    for v in values:
        if v != v or v == float("inf"):
            s += "·"
            continue
        t = (v - lo) / span
        if invert:
            t = 1 - t
        s += blocks[min(7, int(t * 8))]
    return s


def device_line() -> str:
    """The card's name and power limit from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _epochs(path) -> int:
    return sum(1 for _ in open(path))


def _reference_lines(s1, s2, reference) -> list:
    """The run's eval points beside the reference logs' at the epochs both
    hold."""
    ref1, ref2 = (rows(path) for path in reference)
    lines = [f"## Against the reference run (`{reference[0]}`, `{reference[1]}`)", "",
             "| stage | epoch | val IoU | reference | val loss (stage 1) / CD (m) | reference |",
             "|---|---|---|---|---|---|"]
    for stage, mine, ref, key in ((1, s1, ref1, "val_loss"), (2, s2, ref2, "val_cd")):
        theirs = {d["epoch"]: d for d in ref}
        for d in mine:
            r = theirs.get(d["epoch"])
            if r is not None:
                lines.append(f"| {stage} | {d['epoch']} | {d['val_iou']:.4f} | {r['val_iou']:.4f} "
                             f"| {d[key]:.4f} | {r[key]:.4f} |")
    return lines + [""]


def render(stage1_log, stage2_log, device=None, reference=None) -> list:
    """The page's lines."""
    s1, s2 = rows(stage1_log), rows(stage2_log)
    n1, n2 = _epochs(stage1_log), _epochs(stage2_log)
    device = device or device_line()
    out = []
    p = out.append

    p("# CURVES_H100 — the port's full-stack convergence run on the synthetic dataset")
    p("")
    p(f"The convergence recipe through the PyTorch/CUDA port on one card ({device}):")
    p("stage 1 (the `kl_d512_m512_l32_mix` VAE at full width) then stage 2 (the")
    p("`kl_d512_m512_l32_d24_edm` DiT at full width, frozen stage-1 VAE, cached latents),")
    p("on the scene-correlated synthetic ColoRadar tree (200 train / 50 val / 50 test")
    p("frames, radar (128, 8, 2) upsampled on the card to (128, 64, 32)), bf16, batch 8,")
    p("seed 0. Configs from `python -m rald_torch.cli.curves_configs`, run by")
    p("`python -m rald_torch.cli.rerun_to_convergence` (`main_ae` -> `main_cache` ->")
    p("`main_generation`); every number on this page was taken on that card.")
    p("")

    p(f"## Stage 1 — LiDAR VAE ({n1} epochs; {device})")
    p("")
    ious = [d["val_iou"] for d in s1]
    cds = [d.get("val_loss", float("nan")) for d in s1]
    p(f"val IoU  {spark(ious)}  {ious[0]:.3f} -> {ious[-1]:.3f}")
    p(f"val loss {spark(cds, invert=True)}  {cds[0]:.3f} -> {cds[-1]:.3f}")
    p("")
    p("| epoch | val IoU | val loss |")
    p("|---|---|---|")
    for d in s1:
        p(f"| {d['epoch']} | {d['val_iou']:.4f} | {d['val_loss']:.4f} |")
    p("")

    p(f"## Stage 2 — conditional latent diffusion ({n2} epochs; {device})")
    p("")
    ious = [d["val_iou"] for d in s2]
    cds = [d["val_cd"] for d in s2]
    p(f"val IoU        {spark(ious)}  {ious[0]:.3f} -> {ious[-1]:.3f}")
    p(f"val Chamfer(m) {spark(cds, invert=True)}  first-finite "
      f"{next((c for c in cds if c != float('inf')), float('nan')):.3f} -> {cds[-1]:.3f}")
    p("")
    p("(table subsampled to every other eval point; full history in the JSONL)")
    p("")
    p("| epoch | val IoU | val CD (m) | val EDM loss |")
    p("|---|---|---|---|")
    for d in s2[::2]:
        cd = d["val_cd"]
        cd = f"{cd:.4f}" if cd != float("inf") else "inf"
        p(f"| {d['epoch']} | {d['val_iou']:.4f} | {cd} | {d['val_loss']:.4f} |")
    p("")
    best = max(s2, key=lambda d: d["val_iou"])
    best_cd = min((d for d in s2 if d["val_cd"] != float("inf")), key=lambda d: d["val_cd"])
    last = s2[-1]
    p(f"Best stage-2: **IoU {best['val_iou']:.3f}** (epoch {best['epoch']}) / "
      f"**CD {best_cd['val_cd']:.3f} m** (epoch {best_cd['epoch']}); final "
      f"epoch {last['epoch']}: IoU {last['val_iou']:.3f} / CD {last['val_cd']:.3f}.")
    p("")

    mid = s2[(len(s2) - 1) // 2]
    p("## Convergence")
    p("")
    p(f"Stage 2 from its half-way eval point to its last: IoU {mid['val_iou']:.3f} (epoch "
      f"{mid['epoch']}) -> {last['val_iou']:.3f} (epoch {last['epoch']}), "
      f"{last['val_iou'] - mid['val_iou']:+.3f}; CD {mid['val_cd']:.3f} -> {last['val_cd']:.3f} m.")
    p(f"Final train loss {json.loads(open(stage2_log).readlines()[-1])['train_loss']:.4f}.")
    p("")
    if reference:
        out.extend(_reference_lines(s1, s2, reference))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("rald_torch curves page from two JSONL logs")
    parser.add_argument("stage1_log")
    parser.add_argument("stage2_log")
    parser.add_argument("--reference", nargs=2, default=None,
                        help="the JAX run's stage-1 and stage-2 logs, for a side-by-side table")
    parser.add_argument("--device", default=None,
                        help="the card's name and power limit (default: from nvidia-smi)")
    args = parser.parse_args(argv)
    print("\n".join(render(args.stage1_log, args.stage2_log, args.device, args.reference)))


if __name__ == "__main__":
    main()
