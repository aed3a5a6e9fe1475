"""Driver ``train_steps``: stage-2 training steps as ``train_one_epoch``
runs them: ``prepare_inputs`` (the frozen VAE's encode) and ``train_step``
(EDM loss, forward and backward, clip, AdamW, EMA), then the host read of
the loss and the gradient norm, on batches from the traffic's pool.

Set-up loads the benchmark's weights into the one training state and
drives it through its first steps with the window's own call and feed, on
batches that all differ; it keeps the first steps' losses, each leaf's
first gradient as the optimizer got it (from Adam's first moment) and each
leaf's change after them. The window continues the same state."""
from __future__ import annotations

import time

import numpy as np
import torch

from rald_bench import spec, traffic, weights, work
from rald_bench.reference.chain import train_steps
from rald_bench.reference.nets import float32_matmuls, set_fp8

NUMBERS = ("loss_rel", "grad_gap", "change_gap")


class Driver:
    def __init__(self, cell: dict, device):
        self.cell, self.dev = cell, torch.device(device)
        self.cfg = cell["config"]["config"]
        self.bench = cell["config"]["bench"]
        self.t = cell["traffic"]
        self.bsz = int(self.t["batch"])
        self.sizes = spec.model_sizes(self.cfg)
        self.dtype = getattr(torch, self.cfg["system"]["compute_dtype"])
        tr = self.cfg["train"]
        self.sched = {
            "lr": float(tr["blr"]) * self.bsz * int(tr.get("accum_iter", 1)) / 256.0,
            "min_lr": float(tr["min_lr"]), "warmup_epochs": float(tr["warmup_epochs"]),
            "epochs": float(tr["epochs"]), "steps_per_epoch": int(self.bench["steps_per_epoch"]),
            "clip_grad": float(tr["clip_grad"]), "count": int(self.bench["start_count"]),
        }
        self.eng = None

    def _weights(self, seed: int, vae_dtype):
        dit, vae = weights.reference_models(self.cfg, self.sizes)
        dit_sd = weights.make_state_dict(dit, spec.seed_int(seed, 13), torch.float32, self.dev)
        vae_sd = weights.make_state_dict(vae, spec.seed_int(seed, 11), vae_dtype, self.dev)
        return dit, vae, dit_sd, vae_sd

    def setup(self, seed: int) -> None:
        from rald_torch.train.gen_engine import GenerationEngine

        self.seed = seed
        split = {}
        t, radar = self.t, self.cfg["dataset"]["radar"]
        self.batches = traffic.train_batches(seed, t["pool_batches"], self.bsz, radar,
                                             self.sizes["lidar_points"])
        self.draws = [{k: torch.from_numpy(v) for k, v in d.items()} for d in traffic.train_draws(
            seed, t["draw_steps"], self.bsz, self.sizes["latents"], self.sizes["channels"])]
        _, _, dit_sd, vae_sd = self._weights(seed, self.dtype)
        t1 = time.perf_counter()
        if self.eng is None:
            self.eng = GenerationEngine(spec.engine_cfg(self.cell["config"]), device=self.dev)
        self.eng.load_state_dicts(vae_state_dict=vae_sd)
        self.state = self.eng.init_state(self.sched["steps_per_epoch"], self.bsz)
        split["engine_and_state_init"] = time.perf_counter() - t1
        c = self.sched["count"]
        zeros = {k: torch.zeros_like(v) for k, v in dit_sd.items()}
        self.state.load(dit_sd, dit_sd, {"count": c, "mu": zeros, "nu": zeros}, c)
        del dit_sd, vae_sd, zeros
        if self.dev.type == "cuda":  # the peak from here on is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        n = int(t["checked_steps"])
        self.losses = []
        t1 = time.perf_counter()
        for k in range(n):
            self.losses.append(self.step(k))
            if k == 0:
                self.grad = self._first_gradient()
        self.change = self._change()
        split["first_steps"] = time.perf_counter() - t1
        self.setup_split = split
        self.next_step = n

    @torch.no_grad()
    def _first_gradient(self) -> dict:
        """Each leaf's gradient norm after the first update, as AdamW got
        it: its first moment over (1 - beta1), from zero moments."""
        st = self.state.optimizer.state
        return {k: float(st[p]["exp_avg"].norm()) / 0.1 for k, p in self.state.params.items()}

    @torch.no_grad()
    def _change(self) -> dict:
        _, _, start, _ = self._weights(self.seed, self.dtype)
        out = {k: float((p - start[k]).norm()) for k, p in self.state.params.items()}
        del start
        return out

    def step(self, k: int, timings=None) -> float:
        b, d = self.batches[k % len(self.batches)], self.draws[k % len(self.draws)]
        latents, cube = self.eng.prepare_inputs(b, eps=d["eps"], timings=timings)
        self.state, m = self.eng.train_step(self.state, latents, cube, rnd=d["rnd"],
                                            noise=d["noise"], timings=timings)
        loss, _ = float(m["loss"]), float(m["grad_norm"])
        return loss

    def window(self, seconds: float, trace: bool, ops=None) -> dict:
        from rald_bench import trace as tr

        ends, summary, stage, stage_steps = [], None, {}, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = self.next_step
        if trace:
            with tr.profiled() as prof:
                for _ in range(int(self.t["profile_steps"])):
                    self.step(k)
                    ends.append(time.perf_counter())
                    k += 1
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
        while time.perf_counter() < deadline:
            self.step(k, stage if trace else None)
            stage_steps += bool(trace)
            ends.append(time.perf_counter())
            k += 1
        self.next_step = k
        window_s = ends[-1] - t0
        if trace:  # read after the window: the reading takes no window time
            summary = tr.summarize(prof, tuple(ops.calls) if ops is not None else ())
            del prof
        bins = np.zeros(10)
        for e in ends:
            bins[min(int((e - t0) / window_s * 10), 9)] += self.bsz
        out = {"steps": len(ends), "frames": self.bsz * len(ends), "window_s": window_s,
               "end_to_end": {"train_frames_per_s": self.bsz * len(ends) / window_s},
               "drift": (bins / (window_s / 10)).tolist()}
        if trace:
            out["ctx"] = {
                "kind": "train", "summary": summary, "ops": ops,
                "stage_ms": {n: v / max(stage_steps, 1) for n, v in stage.items()},
                "stage_steps": stage_steps,
                "model_flops": self.bsz * int(self.t["profile_steps"]) * work.train_frame(self.sizes),
            }
        return out

    def release(self) -> None:
        """The engine and its state freed (the checked steps' readings are
        kept on the host)."""
        self.eng = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, fp8: bool = False, half: bool = False) -> tuple:
        """The reference's first steps from the same weights, batches and
        draws (``fp8``: the float8 control; ``half``: the half-batch fault)."""
        dit, vae, dit_sd, vae_sd = self._weights(self.seed, self.dtype)
        dit, vae = weights.load_f32(dit, dit_sd, self.dev), weights.load_f32(vae, vae_sd, self.dev)
        del dit_sd, vae_sd
        dit.train()
        set_fp8(dit, fp8)
        dev = lambda a: torch.as_tensor(np.asarray(a), device=self.dev)
        n = int(self.t["checked_steps"])
        batches = [{**{k: dev(v) for k, v in self.batches[i % len(self.batches)].items()},
                    **{k: v.to(self.dev) for k, v in self.draws[i % len(self.draws)].items()}}
                   for i in range(n)]
        with float32_matmuls():
            return train_steps(dit, vae, batches, self.sched, half=half)

    def judge(self, recs=None, control: bool = False, fault: str = "") -> dict:
        """The compared numbers: the program's (or with ``control`` the
        float8 reference's, or with ``fault="half"`` the half-batch
        reference's) first steps against the reference's."""
        ref = self.reference()
        got = (self.reference(fp8=True) if control else self.reference(half=True) if fault == "half"
               else (self.losses, self.grad, self.change))
        return compare(got, ref)


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def compare(prog: tuple, ref: tuple) -> dict:
    """Losses, first gradients and changes by the worst leaf; leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (their moves are round-off)."""
    (lp, gp, cp), (lr, gr, cr) = prog, ref
    med = float(np.median(list(gr.values())))
    keep = [k for k, v in gr.items() if v >= 1e-3 * med]
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
        "grad_gap": _worst_leaf(gp, gr, keep),
        "change_gap": _worst_leaf(cp, cr, keep),
    }
