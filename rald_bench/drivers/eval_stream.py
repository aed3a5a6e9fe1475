"""Driver ``eval_stream``: a closed loop of the product eval step.

Each step hands one batch of the traffic's frames and prior draws to
``GenerationEngine.fused_eval_step`` with the product flags (device grid,
CFAR helpers densified on the device, refine, Chamfer / F) and ends with
the host readback of loss, IoU, accuracy, CD and F that the dataset eval
loop makes for each batch. The next step starts when the readback is done.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from rald_bench import spec, traffic, weights, work
from rald_bench.reference.chain import BatchMismatch, run_chain
from rald_bench.reference.nets import float32_matmuls, set_fp8

NUMBERS = ("cond_rel", "latent_rel", "logit_rel", "loss_rel", "acc_gap", "query_gap", "grid_flip",
           "refine_flip", "cd_rel", "f_gap")


class Driver:
    def __init__(self, cell: dict, device):
        self.cell, self.dev = cell, torch.device(device)
        self.cfg = cell["config"]["config"]
        self.bench = cell["config"]["bench"]
        self.t = cell["traffic"]
        self.bsz = int(self.t["batch"])
        self.sizes = spec.model_sizes(self.cfg)
        self.ev = spec.eval_settings(self.cfg, self.dev)
        self.dtype = getattr(torch, self.cfg["system"]["compute_dtype"])
        self.eng = None

    # ------------------------------------------------------------ set-up
    def _state_dicts(self, seed: int, shift: float = 0.0):
        dit, vae = weights.reference_models(self.cfg, self.sizes)
        dit_sd = weights.make_state_dict(dit, spec.seed_int(seed, 10), self.dtype, self.dev)
        vae_sd = weights.make_state_dict(vae, spec.seed_int(seed, 11), self.dtype, self.dev)
        vae_sd["decoder_cross_attn.fn.to_q.weight"] *= float(self.bench["decoder_to_q_scale"])
        vae_sd["to_outputs.bias"] += shift
        return dit, vae, dit_sd, vae_sd

    def _reference(self, seed: int, shift: float, fp8: bool = False):
        dit, vae, dit_sd, vae_sd = self._state_dicts(seed, shift)
        dit, vae = weights.load_f32(dit, dit_sd, self.dev), weights.load_f32(vae, vae_sd, self.dev)
        set_fp8(dit, fp8)
        set_fp8(vae, fp8)
        return dit, vae

    def setup(self, seed: int) -> None:
        """Weights and traffic from ``seed``, the occupancy bias centred by
        the reference, the engine built and loaded, every shape warmed."""
        from rald_torch.train.gen_engine import GenerationEngine

        self.seed = seed
        split, t0 = {}, time.perf_counter()
        t, radar = self.t, self.cfg["dataset"]["radar"]
        self.frames = traffic.eval_frames(seed, t["pool_frames"], radar, t)
        self.priors = traffic.priors(seed, t["prior_steps"] * self.bsz, self.sizes["latents"],
                                     self.sizes["channels"])
        self.surface_mask = np.ones((self.bsz, t["n_surface"]), bool)
        n_c = int(t["centre_frames"])
        dit, vae = self._reference(seed, 0.0)
        self.shift = weights.centred_bias(dit, vae, self.frames["radar_cube"][:n_c],
                                          self.priors[:n_c], self.ev, spec.seed_int(seed, 12))
        del dit, vae
        split["traffic_and_centring"] = time.perf_counter() - t0
        _, _, dit_sd, vae_sd = self._state_dicts(seed, self.shift)
        if self.eng is None:
            t1 = time.perf_counter()
            self.eng = GenerationEngine(spec.engine_cfg(self.cell["config"]), device=self.dev)
            split["engine_init"] = time.perf_counter() - t1
            self._capture()
        self.eng.load_state_dicts(edm_state_dict=dit_sd, vae_state_dict=vae_sd)
        del dit_sd, vae_sd
        if self.dev.type == "cuda":  # the peak from here on is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.records, w = [], int(t["warmup_steps"])
        rng = np.random.default_rng(spec.seed_int(seed, 30))
        self.check_ks = set((w + rng.choice(int(t["check_window"]), int(t["check_batches"]),
                                            replace=False)).tolist())
        t1 = time.perf_counter()
        for k in range(w):
            self.step(k)
        split["warmup_steps"] = time.perf_counter() - t1
        self.setup_split = split
        self.next_step = w

    def _capture(self) -> None:
        """Keep a checked step's condition tokens, latents, and the query sets
        and logits of its three decodes (eval queries, grid + helpers,
        refine): the outputs of the engine's own calls, unchanged."""
        eng, vae = self.eng, self.eng.vae
        cond_fn, sample_fn, decode_fn = eng.condition, eng.sample_from_cond, vae.decode_queries
        self.cap = None

        def condition(*a, **kw):
            out = cond_fn(*a, **kw)
            if self.cap is not None:
                self.cap["cond"] = out
            return out

        def sample_from_cond(*a, **kw):
            out = sample_fn(*a, **kw)
            if self.cap is not None:
                self.cap["latents"] = out
            return out

        def decode_queries(h, queries):
            out = decode_fn(h, queries)
            if self.cap is not None:
                self.cap.setdefault("decodes", []).append((queries, out.squeeze(-1)))
            return out

        eng.condition, eng.sample_from_cond, vae.decode_queries = condition, sample_from_cond, decode_queries

    # ------------------------------------------------------------ the loop
    def step(self, k: int, timings=None) -> tuple:
        """Step ``k``: hand the batch over, run the step, read back. Returns
        (handed, done) host times."""
        b = self._inputs(k)
        gen = self._gen(k)
        self.cap = {} if k in self.check_ks else None
        handed = time.perf_counter()
        loss, iou, acc, cd, f, n_pred = self.eng.fused_eval_step(
            b["radar_cube"], b["prior"], b["q_eval"], b["labels"], b["labels"], None, gen, b["helper"],
            b["helper_mask"], b["surface"], self.surface_mask, has_mask=False, compute_cd=True,
            refine=True, helper_aug=True, use_device_grid=True, timings=timings)
        host = (float(loss), float(iou), float(acc), float(cd.float().mean()), float(f.float().mean()))
        done = time.perf_counter()
        if self.cap is not None:
            (_, logits), (q_grid, l_grid), (q_ref, l_ref) = self.cap.pop("decodes")
            self.records.append({"k": k, "host": host, "cd": cd, "f": f, "logits": logits,
                                 "q_grid": q_grid, "l_grid": l_grid, "q_ref": q_ref, "l_ref": l_ref,
                                 **self.cap})
            self.cap = None
        return handed, done

    def window(self, seconds: float, trace: bool, ops=None) -> dict:
        """Steps until ``seconds`` have passed. Traced: the first
        ``profile_steps`` steps under the profiler (op ranges on), the rest
        with the engine's stage timings."""
        from rald_bench import trace as tr

        lat, ends, summary, stage, stage_steps = [], [], None, {}, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = self.next_step
        if trace:
            ops.recording = True
            with tr.profiled() as prof:
                for _ in range(int(self.t["profile_steps"])):
                    handed, done = self.step(k)
                    lat.append(done - handed)
                    ends.append(done)
                    k += 1
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
            ops.recording = False
        while time.perf_counter() < deadline:
            handed, done = self.step(k, stage if trace else None)
            stage_steps += bool(trace)
            lat.append(done - handed)
            ends.append(done)
            k += 1
        self.next_step = k
        window_s = ends[-1] - t0
        if trace:  # read after the window: the reading takes no window time
            summary = tr.summarize(prof, tuple(ops.calls) if ops is not None else ())
            del prof
        frames = self.bsz * len(ends)
        bins = np.zeros(10)
        for e in ends:
            bins[min(int((e - t0) / window_s * 10), 9)] += self.bsz
        out = {
            "steps": len(ends), "frames": frames, "window_s": window_s,
            "end_to_end": {"frames_per_s": frames / window_s,
                           "frame_ms_p90": float(np.percentile(np.array(lat) * 1e3, 90))},
            "drift": (bins / (window_s / 10)).tolist(),
        }
        if trace:
            n_q = self.t["n_eval"] + self.ev["num_query"] + self.ev["helper_num"] + self.ev["refine_num"]
            nfe = 2 * self.ev["sampler"]["num_steps"] - 1
            out["ctx"] = {
                "kind": "eval", "summary": summary, "ops": ops,
                "stage_ms": {n: v / max(stage_steps, 1) for n, v in stage.items()},
                "stage_steps": stage_steps,
                "model_flops": self.bsz * int(self.t["profile_steps"]) * work.eval_frame(self.sizes, nfe, n_q),
            }
        return out

    # ------------------------------------------------------------ the check
    def release(self) -> list:
        """The checked steps' records, and the engine freed."""
        recs, self.records, self.eng, self.cap = self.records, [], None, None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return recs

    def judge(self, recs: list, control: bool = False) -> dict:
        """The compared numbers over ``recs`` (the program's, or with
        ``control`` the control's in the program's place: the reference in
        float8 e4m3 with its query arithmetic in bfloat16 and its distances
        in TF32), each the worst over the checked frames."""
        with float32_matmuls():
            ref = self._reference(self.seed, self.shift)
            if control:
                ctl = self._reference(self.seed, self.shift, fp8=True)
                recs = [self._control_record(ctl, r["k"]) for r in recs]
                del ctl
            vals = {n: 0.0 for n in NUMBERS}
            for r in recs:
                try:
                    got = compare(r, run_chain(*ref, self._inputs(r["k"]), self.ev, self._gen(r["k"]),
                                               forced=r))
                except BatchMismatch:
                    got = {n: float("inf") for n in NUMBERS}
                for n, v in got.items():
                    vals[n] = max(vals[n], v)
        return vals

    def _inputs(self, k: int) -> dict:
        return traffic.eval_batch(self.frames, self.priors, k, self.bsz)

    def _gen(self, k: int):
        return torch.Generator(self.dev).manual_seed(spec.seed_int(self.seed, 20, k))

    def _control_record(self, ctl, k: int) -> dict:
        out = run_chain(*ctl, self._inputs(k), self.ev, self._gen(k), low=True)
        return {**out, "k": k, "host": (out["loss"], out["iou"], out["acc"]),
                "cd": torch.tensor(out["cd"]), "f": torch.tensor(out["f"])}


def _rel(a, b) -> float:
    """Worst per-frame ||a - b|| / ||b|| (inf where the shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.float().flatten(1), b.float().flatten(1).to(a.device)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


def _flip(a, b) -> float:
    """Worst per-frame share of queries whose hit (logit > 0) differs."""
    if a.shape != b.shape:
        return 1.0
    return float(((a > 0) != (b.to(a.device) > 0)).float().mean(1).max())


def _gap(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.to(b.device).float() - b).abs().max())


def compare(prog: dict, ref: dict) -> dict:
    """One checked batch: each stage of the program against the reference
    run from the program's output of the stage before."""
    loss, _, acc = prog["host"][:3]
    cd_p, cd_r = prog["cd"].cpu().double(), torch.tensor(ref["cd"], dtype=torch.float64)
    cd_rel = (torch.where(torch.isinf(cd_p) & torch.isinf(cd_r), 0.0,
                          (cd_p - cd_r).abs() / cd_r.abs().clamp_min(1e-12))
              if cd_p.shape == cd_r.shape else torch.full((1,), float("inf")))
    f_p, f_r = prog["f"].cpu().double(), torch.tensor(ref["f"], dtype=torch.float64)
    return {
        "cond_rel": _rel(prog["cond"], ref["cond"]),
        "latent_rel": _rel(prog["latents"], ref["latents"]),
        "logit_rel": _rel(prog["logits"], ref["logits"]),
        "loss_rel": abs(loss - ref["loss"]) / max(abs(ref["loss"]), 1e-12),
        "acc_gap": abs(acc - ref["acc"]),
        "query_gap": max(_gap(prog["q_grid"], ref["q_grid"]), _gap(prog["q_ref"], ref["q_ref"])),
        "grid_flip": _flip(prog["l_grid"], ref["l_grid"]),
        "refine_flip": _flip(prog["l_ref"], ref["l_ref"]),
        "cd_rel": float(torch.nan_to_num(cd_rel, nan=float("inf")).max()),
        "f_gap": _gap(f_p, f_r),
    }
