"""Driver ``flow_eval_stream_v2_1``: the closed loop of ``flow_eval_stream``
for Hunyuan3D-2.1's shape generator (the U-Net DiT with mixture-of-experts
feed-forwards, and the ShapeVAE decoder).

The steps, the set-up (the engine first, then the traffic, the occupancy
bias centred by the reference on one probe frame, the seeded weights) and
the check (:func:`rald_bench.reference.hunyuan3d.run_flow_chain`, stage by
stage) are ``flow_eval_stream``'s; the reference DiT is
:class:`rald_bench.reference.hunyuan3d_v2_1.Hunyuan3DDiTPlain` and the work
:mod:`rald_bench.work_hy3d21`'s. A traced window also reads, after the
window, what the program's mixtures did (``GenerationEngine.moe_counts()``,
snapshotted on the device around the steps, so the window pays no
synchronise): each expert's tokens over the window (``moe``), and over the
profiled steps the routed rows and calls of the grouped expert kernel with
the device time of the kernels named ``moe_grouped_ffn`` in the profile
(``moe_grouped_ffn``: the replayed sampler calls no wrapper the harness
could time). A program whose DiT has no mixtures reads none of these."""
from __future__ import annotations

import time

import numpy as np
import torch

from rald_bench import spec, weights, work_hy3d21
from rald_bench.drivers import flow_eval_stream
from rald_bench.drivers.flow_eval_stream import COUNTS, DECODER_SPANS, span_seconds
from rald_bench.reference import hunyuan3d as ref
from rald_bench.reference import hunyuan3d_v2_1 as ref21

KERNEL = "moe_grouped_ffn"  # a substring of the grouped expert kernel's symbol


def kernel_seconds(prof, name: str) -> float:
    """The device seconds of the kernels whose name holds ``name``."""
    from rald_bench import trace as tr

    return sum(k.time_range.end - k.time_range.start for k in tr._kernels(list(prof.events()))
               if name in k.name) * 1e-6


class Driver(flow_eval_stream.Driver):
    def __init__(self, cell: dict, device):
        conf = cell["config"]
        self.cell, self.dev = cell, torch.device(device)
        self.cfg, self.bench, self.t = conf["config"], conf["bench"], cell["traffic"]
        self.pub = conf["published"]
        self.bsz = int(self.t["batch"])
        self.sizes = work_hy3d21.sizes(conf)
        inf = self.cfg["eval"]["inference"]
        self.ev = spec.eval_settings(self.cfg, self.dev)
        self.ev["sampler"] = {"num_steps": int(inf["num_steps"]),
                              "guidance_scale": float(inf["guidance_scale"]),
                              "scale_factor": float(self.pub["vae"]["scale_factor"])}
        self.ev["view_cone"] = bool(self.cfg["dataset"]["lidar"].get("view_cone_mode", False))
        self.dtype = getattr(torch, self.cfg["system"]["compute_dtype"])
        self.eng, self.judged = None, None

    # ------------------------------------------------------------ set-up
    def _reference_models(self):
        d, v = self.pub["dit"], self.pub["vae"]
        with torch.device("meta"):
            dit = ref21.Hunyuan3DDiTPlain(
                in_channels=d["in_channels"], hidden_size=d["hidden_size"],
                context_dim=d["context_dim"], depth=d["depth"], num_heads=d["num_heads"],
                num_moe_layers=d["num_moe_layers"], num_experts=d["num_experts"],
                moe_top_k=d["moe_top_k"])
            vae = ref.ShapeVAE(
                num_latents=v["num_latents"], embed_dim=v["embed_dim"], width=v["width"],
                heads=v["heads"], num_decoder_layers=v["num_decoder_layers"],
                num_freqs=v["num_freqs"], include_pi=v["include_pi"], qkv_bias=v["qkv_bias"],
                mlp_expand_ratio=v["geo_decoder_mlp_expand_ratio"])
        return dit, vae

    def _state_dicts(self, seed: int, shift: float = 0.0):
        """Seeded weights (``rald_bench.weights``), the RMS QK-norm weights
        at 1 (their public init), the decoder's q-norm scaled
        (``decoder_q_norm_scale``) and the occupancy bias shifted."""
        dit, vae = self._reference_models()
        dit_sd = weights.make_state_dict(dit, spec.seed_int(seed, 10), self.dtype, self.dev)
        for k, v in dit_sd.items():
            if k.endswith((".q_norm.weight", ".k_norm.weight")):
                v.fill_(1.0)
        vae_sd = weights.make_state_dict(vae, spec.seed_int(seed, 11), self.dtype, self.dev)
        vae_sd["geo_decoder.cross_attn_decoder.attn.attention.q_norm.weight"] *= float(
            self.bench["decoder_q_norm_scale"])
        vae_sd["geo_decoder.output_proj.bias"] += shift
        return dit, vae, dit_sd, vae_sd

    # ------------------------------------------------------------ the loop
    def _moe_snapshot(self):
        """Device copies of the mixtures' counters (no synchronise), or None."""
        layers = getattr(self.eng.model, "moe_layers", None)
        if layers is None or not layers():
            return None
        return [torch.stack([m.tokens for m in layers()]).clone(),
                torch.stack([m.calls for m in layers()]).clone()]

    def window(self, seconds: float, trace: bool, ops=None) -> dict:
        """Steps until ``seconds`` have passed, as ``flow_eval_stream``'s;
        traced, the context also holds the timed steps' ``flow_counts``,
        the profiled steps' (``profiled_counts``), the device seconds of
        their decoder spans (``decoder_s``), the mixtures' counts
        (``moe``, ``moe_grouped_ffn``) and the published model's work
        (``rald_bench.work_hy3d21``)."""
        from rald_bench import trace as tr

        lat, ends, summary, stage, stage_steps = [], [], None, {}, 0
        self.stage_counts = dict.fromkeys(COUNTS, 0)
        snaps = [self._moe_snapshot()] if trace else []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = self.next_step
        if trace:
            ops.recording = True
            before = self.eng.flow_counts()
            with tr.profiled() as prof:
                for _ in range(int(self.t["profile_steps"])):
                    handed, done = self.step(k)
                    lat.append(done - handed)
                    ends.append(done)
                    k += 1
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
            ops.recording = False
            after = self.eng.flow_counts()
            profiled = {n: after[n] - before[n] for n in COUNTS}
            snaps.append(self._moe_snapshot())
        while time.perf_counter() < deadline:
            handed, done = self.step(k, stage if trace else None)
            stage_steps += bool(trace)
            lat.append(done - handed)
            ends.append(done)
            k += 1
        self.next_step = k
        window_s = ends[-1] - t0
        if trace:  # read after the window: the reading takes no window time
            snaps.append(self._moe_snapshot())
            summary = tr.summarize(prof, tuple(ops.calls) if ops is not None else ())
            decoder_s = span_seconds(prof, DECODER_SPANS, self.dev)
            moe_s = kernel_seconds(prof, KERNEL) if self.dev.type == "cuda" else 0.0
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
            ev = self.ev
            n_q = self.t["n_eval"] + ev["num_query"] + ev["helper_num"] + ev["refine_num"]
            frame = work_hy3d21.eval_frame(self.sizes, ev["sampler"]["num_steps"], n_q)
            out["ctx"] = {
                "kind": "eval", "summary": summary, "ops": ops,
                "stage_ms": {n: v / max(stage_steps, 1) for n, v in stage.items()},
                "stage_steps": stage_steps,
                "model_flops": self.bsz * int(self.t["profile_steps"]) * frame,
                "flow_counts": dict(self.stage_counts),
                "profiled_counts": profiled, "decoder_s": decoder_s,
            }
            if snaps[0] is not None:
                (tok0, _), (tok1, calls1), (tok2, _) = [[t.cpu() for t in s] for s in snaps]
                calls0 = snaps[0][1].cpu()
                out["ctx"]["moe"] = {"tokens": (tok2 - tok0).tolist()}
                out["ctx"]["moe_grouped_ffn"] = {
                    "rows": int((tok1 - tok0).sum()), "calls": int((calls1 - calls0).sum()),
                    "device_s": moe_s}
        return out
