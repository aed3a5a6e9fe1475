"""The plain reference against ``rald_torch``'s plain path at tiny widths
on the CPU, in float32 on both sides: the same seeded weights load into
both (strictly: the layouts agree), and each stage agrees to float32
rounding. This holds the reference before any chip time is spent."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from rald_bench import spec, traffic, weights
from rald_bench.reference.chain import run_chain, train_steps


@pytest.fixture
def f32_eval(tiny_cell):
    cell = copy.deepcopy(tiny_cell("tiny_eval_b2"))
    cfg = cell["config"]["config"]
    cfg["system"]["compute_dtype"] = "float32"
    cfg["system"]["fast_inference"] = False
    return cell


def _models(cell, seed):
    cfg = cell["config"]["config"]
    sizes = spec.model_sizes(cfg)
    dit, vae = weights.reference_models(cfg, sizes)
    dit_sd = weights.make_state_dict(dit, seed, torch.float32, "cpu")
    vae_sd = weights.make_state_dict(vae, seed + 1, torch.float32, "cpu")
    vae_sd["decoder_cross_attn.fn.to_q.weight"] *= 10.0
    return (weights.load_f32(dit, dit_sd, "cpu"), weights.load_f32(vae, vae_sd, "cpu"),
            dit_sd, vae_sd, sizes)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_eval_chain_matches_the_port(f32_eval):
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = f32_eval["config"]["config"]
    dit, vae, dit_sd, vae_sd, sizes = _models(f32_eval, 77)
    eng = GenerationEngine(spec.engine_cfg(f32_eval["config"]), device="cpu")
    eng.load_state_dicts(edm_state_dict=dit_sd, vae_state_dict=vae_sd)
    t = f32_eval["traffic"]
    frames = traffic.eval_frames(3, 2, cfg["dataset"]["radar"], t)
    prior = traffic.priors(3, 2, sizes["latents"], sizes["channels"])
    ev = spec.eval_settings(cfg, torch.device("cpu"))
    cond = eng.condition(frames["radar_cube"])
    latents = eng.sample_from_cond(cond, prior)
    ref = run_chain(dit, vae, {**frames, "prior": prior}, ev, torch.Generator().manual_seed(5))
    assert _rel(cond, ref["cond"]) < 1e-5
    assert _rel(latents, ref["latents"]) < 1e-4
    logits = eng.decode_queries(latents, frames["q_eval"])
    assert _rel(logits, ref["logits"]) < 1e-4
    loss, iou, acc, cd, f, n_pred = eng.fused_eval_step(
        frames["radar_cube"], prior, frames["q_eval"], frames["labels"], frames["labels"], None,
        torch.Generator().manual_seed(5), frames["helper"], frames["helper_mask"], frames["surface"],
        np.ones(frames["surface"].shape[:2], bool), helper_aug=True)
    assert abs(float(loss) - ref["loss"]) < 1e-4 * abs(ref["loss"])
    assert abs(float(acc) - ref["acc"]) <= 1.0 / frames["labels"].shape[1]
    np.testing.assert_allclose(n_pred.numpy(), ref["n_pred"], rtol=2e-3)
    np.testing.assert_allclose(cd.numpy(), ref["cd"], rtol=2e-2)


def test_train_steps_match_the_port(tiny_cell):
    from rald_torch.train.gen_engine import GenerationEngine

    cell = copy.deepcopy(tiny_cell("tiny_train_b2"))
    cfg = cell["config"]["config"]
    cfg["system"]["compute_dtype"] = "float32"
    dit, vae, dit_sd, vae_sd, sizes = _models(cell, 88)
    eng = GenerationEngine(spec.engine_cfg(cell["config"]), device="cpu")
    eng.load_state_dicts(vae_state_dict=vae_sd)
    tr = {"lr": 1e-4 * 2 / 256, "min_lr": 1e-6, "warmup_epochs": 2.0, "epochs": 100.0,
          "steps_per_epoch": 10, "clip_grad": 10.0, "count": 20}
    state = eng.init_state(tr["steps_per_epoch"], 2)
    zeros = {k: torch.zeros_like(v) for k, v in dit_sd.items()}
    state.load(dit_sd, dit_sd, {"count": 20, "mu": zeros, "nu": zeros}, 20)
    batches = traffic.train_batches(4, 2, 2, cfg["dataset"]["radar"], sizes["lidar_points"])
    draws = traffic.train_draws(4, 2, 2, sizes["latents"], sizes["channels"])
    losses = []
    for b, d in zip(batches, draws):
        lat, cube = eng.prepare_inputs(b, eps=torch.from_numpy(d["eps"]))
        state, m = eng.train_step(state, lat, cube, rnd=torch.from_numpy(d["rnd"]),
                                  noise=torch.from_numpy(d["noise"]))
        losses.append(float(m["loss"]))
    ref_batches = [{**{k: torch.from_numpy(v) for k, v in b.items()},
                    **{k: torch.from_numpy(v) for k, v in d.items()}} for b, d in zip(batches, draws)]
    ref_losses, grad, change = train_steps(dit.train(), vae, ref_batches, tr)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    got = {k: float((p - dit_sd[k]).norm()) for k, p in state.params.items()}
    # the benchmark's rule: leaves whose reference gradient is under a
    # thousandth of the median leaf's move by round-off and are left out
    keep = [k for k, v in grad.items() if v >= 1e-3 * np.median(list(grad.values()))]
    med = float(np.median([change[k] for k in keep]))
    assert max(abs(got[k] - change[k]) / max(change[k], med) for k in keep) < 1e-3
