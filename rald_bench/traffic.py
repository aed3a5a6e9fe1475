"""The one traffic generator: inputs in the product's raw shapes, made from
the run's seed and a traffic mix's parameters (``traffic/<name>.json``).

Every seed gives the same sizes; the seed changes only the values. Frames
(eval) or batches (training) are made at set-up as a pool on the host, in
numpy, and a step takes its pool entries in turn; the prior draws
(eval) and the posterior / EDM draws (training) come from a second pool of
their own, so that each cycle over the frames meets new draws."""
from __future__ import annotations

import numpy as np


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), tag])


def eval_frames(seed: int, n: int, radar: dict, t: dict) -> dict:
    """``n`` synthetic eval frames: a normal (R, A, E, C) radar cube,
    ``n_eval`` uniform eval queries with labels (10 % occupied), up to
    ``n_cfar`` raw CFAR points (a ragged count, half to all of them valid)
    and ``n_surface`` GT surface points on a shell at a tenth of the range."""
    g = _rng(seed, 1)
    f32 = np.float32
    cube = g.standard_normal((n, int(radar["input_r_dim"]), int(radar["input_a_dim"]),
                              int(radar["input_e_dim"]), int(radar["input_ch"])), f32)
    n_eval, n_cfar, n_surf = t["n_eval"], t["n_cfar"], t["n_surface"]
    q_eval = g.uniform(-1, 1, (n, n_eval, 3)).astype(f32)
    labels = (g.uniform(size=(n, n_eval)) < 0.1).astype(f32)
    helper = g.uniform(-1, 1, (n, n_cfar, 3)).astype(f32)
    helper_mask = np.arange(n_cfar)[None] < g.integers(n_cfar // 2, n_cfar, (n, 1))
    surface = g.uniform(-1, 1, (n, n_surf, 3)).astype(f32)
    surface[..., 0] = np.clip(0.3 + 0.05 * g.standard_normal((n, n_surf)), -1, 1)
    return {"radar_cube": cube, "q_eval": q_eval, "labels": labels, "helper": helper,
            "helper_mask": helper_mask, "surface": surface}


def priors(seed: int, n: int, latents: int, channels: int) -> np.ndarray:
    """``n`` unit-normal (latents, channels) prior draws."""
    return _rng(seed, 2).standard_normal((n, latents, channels), np.float32)


def eval_batch(frames: dict, prior_pool: np.ndarray, step: int, bsz: int) -> dict:
    """Step ``step``'s batch: frames ``step * bsz ..`` of the pool, wrapping,
    and prior draws ``step * bsz ..`` of theirs."""
    nf, npr = len(frames["radar_cube"]), len(prior_pool)
    fi = [(step * bsz + i) % nf for i in range(bsz)]
    pi = [(step * bsz + i) % npr for i in range(bsz)]
    out = {k: v[fi] for k, v in frames.items()}
    out["prior"] = prior_pool[pi]
    return out


def train_batches(seed: int, n: int, bsz: int, radar: dict, n_points: int) -> list:
    """``n`` training batches of ``bsz`` frames: a normal radar cube and a
    LiDAR cloud of ``n_points`` points in the normalised box (range on a
    shell, as the surface above)."""
    g = _rng(seed, 3)
    f32 = np.float32
    out = []
    for _ in range(n):
        cube = g.standard_normal((bsz, int(radar["input_r_dim"]), int(radar["input_a_dim"]),
                                  int(radar["input_e_dim"]), int(radar["input_ch"])), f32)
        pts = g.uniform(-1, 1, (bsz, n_points, 3)).astype(f32)
        pts[..., 0] = np.clip(0.3 + 0.05 * g.standard_normal((bsz, n_points)), -1, 1)
        out.append({"radar_cube": cube, "lidar_points": pts})
    return out


def train_draws(seed: int, n: int, bsz: int, latents: int, channels: int) -> list:
    """``n`` steps' draws: posterior ``eps`` (B, M, C), EDM ``rnd`` (B, 1, 1)
    and ``noise`` (B, M, C), unit normal."""
    g = _rng(seed, 4)
    f32 = np.float32
    return [{"eps": g.standard_normal((bsz, latents, channels), f32),
             "rnd": g.standard_normal((bsz, 1, 1), f32),
             "noise": g.standard_normal((bsz, latents, channels), f32)} for _ in range(n)]
