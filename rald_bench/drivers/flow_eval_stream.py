"""Driver ``flow_eval_stream``: the closed loop of ``eval_stream`` for a
flow-matching shape generator (Hunyuan3D-2.0's DiT and ShapeVAE decoder).

Each step hands one batch of the pool's condition tokens (an image
encoder's output, drawn from the seed) and prior draws to
``GenerationEngine.fused_eval_step`` with the product flags (device grid,
helpers densified on the device, refine, Chamfer / F), and ends with the
host readback of loss, IoU, accuracy, CD and F. The timed steps' DiT calls,
rows and decoded queries are read from the engine's ``flow_counts()``, and
the profiled steps' too, beside the device time of the decoder's spans
(:func:`span_seconds`); the check runs :func:`rald_bench.reference.hunyuan3d.run_flow_chain` stage by
stage, with the numbers of ``eval_stream``.

``python -m rald_bench.readings`` reaches this driver through its
training branch: :meth:`Driver.judge` without records runs the checked
steps itself, and has no half-batch fault at B 1."""
from __future__ import annotations

import bisect
import time

import numpy as np
import torch

from rald_bench import spec, traffic, weights, work_hy3d
from rald_bench.drivers import eval_stream
from rald_bench.drivers.eval_stream import NUMBERS, compare
from rald_bench.reference import hunyuan3d as ref
from rald_bench.reference.chain import BatchMismatch
from rald_bench.reference.nets import float32_matmuls

COUNTS = ("evaluations", "rows", "queries_decoded")
# the program's spans around the ShapeVAE decoder's work: the latent stack
# and each decode's keys and values, and the query blocks
DECODER_SPANS = ("vae_stack", "decode_block")


def span_seconds(prof, names, device) -> float:
    """The seconds of the work inside the program's spans ``names``
    (``rald::<name>`` ranges, none nested in another) in a profile. On the
    card, the device time of the kernels launched inside them: a kernel
    belongs to the span open on the launching thread at its launch call, as
    :func:`rald_bench.trace.summarize` gives kernels to op ranges. On the
    CPU, where the host does the work, the spans' own time."""
    from rald_bench import trace as tr

    events = list(prof.events())
    front = [e for e in events if e.device_type.name == "CPU" and not getattr(e, "is_async", False)]
    wanted = {"rald::" + n for n in names}
    ranges = {}  # thread -> sorted [(start, end)]
    for e in sorted(front, key=lambda e: e.time_range.start):
        if e.name in wanted:
            ranges.setdefault(e.thread, []).append((e.time_range.start, e.time_range.end))
    if device.type != "cuda":
        return sum(b - a for rs in ranges.values() for a, b in rs) * 1e-6
    launches = {e.id: e for e in front if "aunch" in e.name}
    starts = {t: [r[0] for r in rs] for t, rs in ranges.items()}
    total = 0.0
    for k in tr._kernels(events):
        launch = launches.get(k.id)
        if launch is None or launch.thread not in ranges:
            continue
        i = bisect.bisect_right(starts[launch.thread], launch.time_range.start) - 1
        if i >= 0 and launch.time_range.start <= ranges[launch.thread][i][1]:
            total += k.time_range.end - k.time_range.start
    return total * 1e-6


class Driver(eval_stream.Driver):
    def __init__(self, cell: dict, device):
        conf = cell["config"]
        self.cell, self.dev = cell, torch.device(device)
        self.cfg, self.bench, self.t = conf["config"], conf["bench"], cell["traffic"]
        self.pub = conf["published"]
        self.bsz = int(self.t["batch"])
        self.sizes = work_hy3d.sizes(conf)
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
            dit = ref.Hunyuan3DDiT(
                in_channels=d["in_channels"], context_in_dim=d["context_in_dim"],
                hidden_size=d["hidden_size"], mlp_ratio=d["mlp_ratio"], num_heads=d["num_heads"],
                depth=d["depth"], depth_single_blocks=d["depth_single_blocks"],
                qkv_bias=d["qkv_bias"], time_factor=d["time_factor"])
            vae = ref.ShapeVAE(
                num_latents=v["num_latents"], embed_dim=v["embed_dim"], width=v["width"],
                heads=v["heads"], num_decoder_layers=v["num_decoder_layers"],
                num_freqs=v["num_freqs"], include_pi=v["include_pi"], qkv_bias=v["qkv_bias"],
                mlp_expand_ratio=v["geo_decoder_mlp_expand_ratio"])
        return dit, vae

    def _state_dicts(self, seed: int, shift: float = 0.0):
        """Seeded weights (``rald_bench.weights``), the RMS QK-norm scales
        at 1 (their public init), the decoder's q-norm scaled
        (``decoder_q_norm_scale``) and the occupancy bias shifted."""
        dit, vae = self._reference_models()
        dit_sd = weights.make_state_dict(dit, spec.seed_int(seed, 10), self.dtype, self.dev)
        for k, v in dit_sd.items():
            if k.endswith((".query_norm.scale", ".key_norm.scale")):
                v.fill_(1.0)
        vae_sd = weights.make_state_dict(vae, spec.seed_int(seed, 11), self.dtype, self.dev)
        vae_sd["geo_decoder.cross_attn_decoder.attn.attention.q_norm.weight"] *= float(
            self.bench["decoder_q_norm_scale"])
        vae_sd["geo_decoder.output_proj.bias"] += shift
        return dit, vae, dit_sd, vae_sd

    def setup(self, seed: int) -> None:
        """The engine first (a program that cannot build the model stops
        here), then the traffic from ``seed``, the occupancy bias centred by
        the reference on one probe frame, the weights loaded, every shape
        warmed (the sampler's first call eager, its second captured)."""
        from rald_torch.train.gen_engine import GenerationEngine

        self.seed, self.judged = seed, None
        split = {}
        if self.eng is None:
            t1 = time.perf_counter()
            self.eng = GenerationEngine(spec.engine_cfg(self.cell["config"]), device=self.dev)
            split["engine_init"] = time.perf_counter() - t1
            self._capture()
        t0 = time.perf_counter()
        t, cond = self.t, self.pub["condition"]
        n_tok, width = int(cond["tokens"]), int(cond["width"])
        shape = {"input_r_dim": n_tok, "input_a_dim": width, "input_e_dim": 1, "input_ch": 1}
        self.frames = traffic.eval_frames(seed, t["pool_frames"], shape, t)
        # the tokens keep the generator's key, as they take the cube's place
        self.frames["radar_cube"] = self.frames["radar_cube"].reshape(-1, n_tok, width)
        self.priors = traffic.priors(seed, t["prior_steps"] * self.bsz, self.sizes["latents"],
                                     self.sizes["channels"])
        self.surface_mask = np.ones((self.bsz, t["n_surface"]), bool)
        n_c = int(t["centre_frames"])
        dit, vae = self._reference(seed, 0.0)
        self.shift = ref.centred_bias(dit, vae, self.frames["radar_cube"][:n_c], self.priors[:n_c],
                                      self.ev, spec.seed_int(seed, 12))
        del dit, vae
        split["traffic_and_centring"] = time.perf_counter() - t0
        _, _, dit_sd, vae_sd = self._state_dicts(seed, self.shift)
        self.eng.load_state_dicts(edm_state_dict=dit_sd, vae_state_dict=vae_sd)
        del dit_sd, vae_sd
        if self.dev.type == "cuda":  # the peak from here on is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.records, w = [], int(t["warmup_steps"])
        rng = np.random.default_rng(spec.seed_int(seed, 30))
        self.check_ks = set((w + rng.choice(int(t["check_window"]), int(t["check_batches"]),
                                            replace=False)).tolist())
        self.stage_counts = dict.fromkeys(COUNTS, 0)
        t1 = time.perf_counter()
        for k in range(w):
            self.step(k)
        split["warmup_steps"] = time.perf_counter() - t1
        self.setup_split = split
        self.next_step = w

    # ------------------------------------------------------------ the loop
    def step(self, k: int, timings=None) -> tuple:
        """Step ``k`` as ``eval_stream``'s, the condition tokens in the cube's
        place; a step with ``timings`` adds its ``flow_counts()`` to
        :attr:`stage_counts`."""
        b = self._inputs(k)
        gen = self._gen(k)
        before = self.eng.flow_counts()
        self.cap = {} if k in self.check_ks else None
        handed = time.perf_counter()
        loss, iou, acc, cd, f, n_pred = self.eng.fused_eval_step(
            b["radar_cube"], b["prior"], b["q_eval"], b["labels"], b["labels"], None, gen, b["helper"],
            b["helper_mask"], b["surface"], self.surface_mask, has_mask=False, compute_cd=True,
            refine=True, helper_aug=True, use_device_grid=True, timings=timings)
        host = (float(loss), float(iou), float(acc), float(cd.float().mean()), float(f.float().mean()))
        done = time.perf_counter()
        if timings is not None:
            after = self.eng.flow_counts()
            for n in COUNTS:
                self.stage_counts[n] += after[n] - before[n]
        if self.cap is not None:
            (_, logits), (q_grid, l_grid), (q_ref, l_ref) = self.cap.pop("decodes")
            self.records.append({"k": k, "host": host, "cd": cd, "f": f, "logits": logits,
                                 "q_grid": q_grid, "l_grid": l_grid, "q_ref": q_ref, "l_ref": l_ref,
                                 **self.cap})
            self.cap = None
        return handed, done

    def window(self, seconds: float, trace: bool, ops=None) -> dict:
        """Steps until ``seconds`` have passed, as ``eval_stream``'s; traced,
        the context also holds the timed steps' ``flow_counts``, the
        profiled steps' (``profiled_counts``) and the device seconds of
        their decoder spans (``decoder_s``), and the published model's work
        (``rald_bench.work_hy3d``)."""
        from rald_bench import trace as tr

        lat, ends, summary, stage, stage_steps = [], [], None, {}, 0
        self.stage_counts = dict.fromkeys(COUNTS, 0)
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
            decoder_s = span_seconds(prof, DECODER_SPANS, self.dev)
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
            frame = work_hy3d.eval_frame(self.sizes, ev["sampler"]["num_steps"], n_q)
            out["ctx"] = {
                "kind": "eval", "summary": summary, "ops": ops,
                "stage_ms": {n: v / max(stage_steps, 1) for n, v in stage.items()},
                "stage_steps": stage_steps,
                "model_flops": self.bsz * int(self.t["profile_steps"]) * frame,
                "flow_counts": dict(self.stage_counts),
                "profiled_counts": profiled, "decoder_s": decoder_s,
            }
        return out

    # ------------------------------------------------------------ the check
    def judge(self, recs: list | None = None, control: bool = False, fault=None) -> dict:
        """The compared numbers over ``recs``, as ``eval_stream``'s. Without
        ``recs`` (``python -m rald_bench.readings``) the ``check_batches``
        steps after the warm-up run first, once a set-up. ``fault``: none at
        B 1 (an empty reading)."""
        if fault is not None:
            return {}
        if recs is None:
            if self.judged is None:
                n = int(self.t["check_batches"])
                self.check_ks = set(range(self.next_step, self.next_step + n))
                for k in sorted(self.check_ks):
                    self.step(k)
                self.next_step += n
                self.judged, self.records = self.records, []
            recs = self.judged
        with float32_matmuls():
            models = self._reference(self.seed, self.shift)
            if control:
                ctl = self._reference(self.seed, self.shift, fp8=True)
                recs = [self._control_record(ctl, r["k"]) for r in recs]
                del ctl
            vals = dict.fromkeys(NUMBERS, 0.0)
            for r in recs:
                try:
                    got = compare(r, ref.run_flow_chain(*models, self._inputs(r["k"]), self.ev,
                                                        self._gen(r["k"]), forced=r))
                except BatchMismatch:
                    got = dict.fromkeys(NUMBERS, float("inf"))
                for n, v in got.items():
                    vals[n] = max(vals[n], v)
        return vals

    def _control_record(self, ctl, k: int) -> dict:
        out = ref.run_flow_chain(*ctl, self._inputs(k), self.ev, self._gen(k), low=True)
        return {**out, "k": k, "host": (out["loss"], out["iou"], out["acc"]),
                "cd": torch.tensor(out["cd"]), "f": torch.tensor(out["f"])}
