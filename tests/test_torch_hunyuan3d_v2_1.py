"""Hunyuan3D-2.1's shape generator in the port
(``rald_torch.models.hunyuan_dit``, the mixtures of
``rald_torch.models.moe``, the 4096-latent ShapeVAE and the engine's flow
path), held to the benchmark's plain float32 reference
(``rald_bench.reference.hunyuan3d_v2_1``, the one copy) on seeded weights
at tiny widths on the CPU (5 blocks: two long skips and two mixtures of 4
experts at top 2); the published widths' parameter counts on the ``meta``
device; the benchmark's cell at a tiny size through its own harness; and
on the card (``python -m pytest -m gpu tests/test_torch_hunyuan3d_v2_1.py``)
the graphed flow sampler against the eager one, bitwise, with the grouped
expert kernel's launches fixed whatever the routing. This file imports no
JAX.

Tolerances: both sides compute in float32 on the CPU, so they differ only
where the port sums in another order (``F.scaled_dot_product_attention``
against the written-out softmax, ``F.rms_norm``, the mixtures' stacked
rows against the per-expert loop, the time tokens of all steps in one
product): 1e-6 relative, held at 2e-5. Guided Euler steps multiply a
velocity's error by up to ``1 + 2 x guidance`` each, so the three-step
sampler is held at 1e-4."""
from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_stand import StandCache
from rald_bench import work_hy3d21
from rald_bench.reference import hunyuan3d as R0
from rald_bench.reference import hunyuan3d_v2_1 as R
from rald_torch.config import Config
from rald_torch.models.hunyuan_dit import Hunyuan3DDiTPlain
from rald_torch.models.registry import get_ae_model, get_generation_model
from rald_torch.train.gen_engine import GenerationEngine, init_random_weights

ROOT = Path(__file__).resolve().parent.parent
DIT = dict(in_channels=8, hidden_size=64, context_dim=24, depth=5, num_heads=4,
           num_moe_layers=2, num_experts=4, moe_top_k=2)
VAE = dict(num_latents=16, embed_dim=8, width=64, heads=4, num_decoder_layers=2)
N_COND = 8  # condition tokens
CFG = {
    "system": {"seed": 0, "compute_dtype": "float32"},
    "dataset": {
        "lidar": {"pc_range": [-1, -1, -1, 1, 1, 1], "voxel_size": [0.0078125] * 3,
                  "num_samples": 512, "norm_isotropy": False, "norm_anisotropy": True,
                  "view_cone_mode": False},
        "query_aug_num": 256, "query_aug_scale": 2,
    },
    "ar_model": {"name": "hunyuan3d_dit_v2_1", "configs": {},
                 "overrides": {**DIT, "n_latents": VAE["num_latents"]}},
    "lidar_ae": {"name": "hunyuan3d_vae_v2_1", "latent_std": 1,
                 "overrides": {**VAE, "query_chunk": 4096}},
    "eval": {"fscore_tau": 0.02, "inference": {
        "num_steps": 3, "guidance_scale": 5.0, "num_query_points": 2048,
        "refine_query_aug_num": 1024, "refine_query_scale": 10}},
}
TOL = dict(rtol=2e-5, atol=2e-5)
EV = {"device": torch.device("cpu"), "num_query": 2048, "helper_num": 256, "helper_scale": 2,
      "refine_num": 1024, "refine_scale": 10, "pc_range": [-1, -1, -1, 1, 1, 1],
      "voxel_size": [0.0078125] * 3, "fscore_tau": 0.02, "view_cone": False}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _cfg(**updates) -> dict:
    d = copy.deepcopy(CFG)
    for path, v in updates.items():
        node = d
        *head, last = path.split(".")
        for k in head:
            node = node[k]
        node[last] = v
    return d


def _engine(device="cpu", **updates) -> GenerationEngine:
    return GenerationEngine(Config(_cfg(**updates)), device=device)


def _reference(eng):
    """The reference DiT and VAE holding the engine's weights, in float32."""
    dit, vae = R.Hunyuan3DDiTPlain(**DIT), R0.ShapeVAE(**VAE, query_chunk=1000)
    dit.load_state_dict({k: v.float().cpu() for k, v in eng.model.state_dict().items()})
    vae.load_state_dict({k: v.float().cpu() for k, v in eng.vae.state_dict().items()})
    return dit.eval(), vae.eval()


def _pair(kw: dict, seed: int = 0):
    """A port DiT of widths ``kw`` with seeded weights and the reference holding them."""
    port = Hunyuan3DDiTPlain(n_latents=16, **kw)
    init_random_weights(port, torch.Generator().manual_seed(seed))
    ref = R.Hunyuan3DDiTPlain(**kw)
    ref.load_state_dict(port.state_dict())
    return port.eval(), ref.eval()


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("kw", [
    DIT,
    dict(in_channels=4, hidden_size=96, context_dim=40, depth=4, num_heads=3,
         num_moe_layers=1, num_experts=3, moe_top_k=1),
], ids=["h64_d5_moe2x4", "h96_d4_moe1x3_top1"])
@torch.no_grad()
def test_denoiser_matches_reference(kw):
    port, ref = _pair(kw, seed=3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, kw["in_channels"], generator=g)
    cond = torch.randn(2, N_COND, kw["context_dim"], generator=g)
    t = torch.tensor([0.0, 0.48])
    torch.testing.assert_close(port(x, t, cond), ref(x, t, cond), **TOL)
    n_moe, n_skip = kw["num_moe_layers"], kw["depth"] - kw["depth"] // 2 - 1
    assert len(port.moe_layers()) == n_moe
    assert sum(b.skip_linear is not None for b in port.blocks) == n_skip
    for m in port.moe_layers():  # one call, every token routed top_k times
        assert sum(m.tokens.tolist()) == kw["moe_top_k"] * 2 * (16 + 1) and int(m.calls) == 1


@torch.no_grad()
def test_long_skip_joins_the_pushed_output_first():
    """``skip_norm(skip_linear([skip ; x]))``: the half of ``skip_linear``
    that reads the pushed block output comes first. Swapping the halves
    (the other order) changes the block's output."""
    port, _ = _pair(DIT, seed=5)
    blk = port.blocks[3]  # the first block past the middle of 5, and the first mixture
    g = torch.Generator().manual_seed(6)
    x, skip, c = (torch.randn(1, 17, 64, generator=g), torch.randn(1, 17, 64, generator=g),
                  torch.randn(1, N_COND, 24, generator=g))
    w, b = blk.skip_linear.weight, blk.skip_linear.bias
    joined = blk.skip_norm(skip @ w[:, :64].T + x @ w[:, 64:].T + b)
    h = joined + blk.attn1(blk.norm1(joined))
    h = h + blk.attn2(blk.norm2(h), c)
    torch.testing.assert_close(blk(x, c, skip), h + blk.moe(blk.norm3(h)), **TOL)
    assert not torch.allclose(blk(x, c, skip), blk(skip, c, x), atol=1e-3)
    # the skips pop in reverse: block 3 takes block 1's output, block 4 block 0's
    seen = []
    for i, b in enumerate(port.blocks):
        b.register_forward_hook(lambda m, a, out, i=i: seen.append((i, a[2])))
    outs = {}
    for i, b in enumerate(port.blocks):
        b.register_forward_hook(lambda m, a, out, i=i: outs.__setitem__(i, out))
    port(torch.randn(1, 16, 8, generator=g), torch.tensor([0.3]), torch.randn(1, N_COND, 24, generator=g))
    skips = dict(seen)
    assert skips[0] is None and skips[2] is None
    assert skips[3] is outs[1] and skips[4] is outs[0]


@torch.no_grad()
def test_time_token_is_first_and_dropped():
    """The time token sits before the latents and the final layer drops it:
    with no blocks, the velocity is the latents' own projection, whatever
    the time; with blocks, the time moves it."""
    port, ref = _pair(DIT, seed=7)
    g = torch.Generator().manual_seed(8)
    x, cond = torch.randn(2, 16, 8, generator=g), torch.randn(2, N_COND, 24, generator=g)
    t = torch.tensor([0.1, 0.9])
    assert not torch.allclose(port(x, t, cond), port(x, t.flip(0), cond))
    port.blocks = torch.nn.ModuleList()
    f = port.final_layer
    want = f.linear(f.norm_final(port.x_embedder(x)))
    torch.testing.assert_close(port(x, t, cond), want, **TOL)
    torch.testing.assert_close(port(x, t.flip(0), cond), want, **TOL)
    tok = port.t_embedder(t)
    torch.testing.assert_close(tok[:, 0], ref.t_embedder.mlp(R0.timestep_embedding(
        t, 64, time_factor=1000.0)), **TOL)


def test_published_parameter_counts():
    """At the published widths, on the ``meta`` device: the hand counts of
    the benchmark's configuration file and of its work module."""
    conf = json.loads((ROOT / "rald_bench/configs/hunyuan3d_dit_v2_1.json").read_text())
    with torch.device("meta"):
        dit = get_generation_model("hunyuan3d_dit_v2_1", {})
        vae = get_ae_model("hunyuan3d_vae_v2_1")
    counts = work_hy3d21.parameters(work_hy3d21.sizes(conf))
    assert sum(p.numel() for p in dit.parameters()) == conf["parameters"]["dit"] == counts["dit"]
    assert conf["parameters"]["dit"] == 3050758720
    moe = sum(p.numel() for m in dit.moe_layers() for p in m.parameters())
    assert moe == conf["parameters"]["moe"] == counts["moe"]
    assert sum(p.numel() for p in vae.parameters()) == conf["parameters"]["vae_decoder"]
    pub = conf["published"]
    assert (dit.n_latents, dit.channels, dit.context_in_dim) == (
        pub["vae"]["num_latents"], pub["dit"]["in_channels"], pub["dit"]["context_dim"])
    assert len(dit.blocks) == 21 and len(dit.moe_layers()) == 6
    assert [i for i, b in enumerate(dit.blocks) if b.skip_linear is not None] == list(range(11, 21))
    assert [i for i, b in enumerate(dit.blocks) if hasattr(b, "moe")] == list(range(15, 21))
    assert vae.scale_factor == pub["vae"]["scale_factor"] and vae.num_latents == 4096


# ------------------------------------------------------------ the engine
def _tokens(bsz, seed):
    return torch.randn(bsz, N_COND, DIT["context_dim"], generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def test_cfg_sampler_matches_two_call_reference():
    eng = _engine()
    dit, _ = _reference(eng)
    tokens = _tokens(2, 7)
    prior = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(8))
    got = eng.sample_from_cond(eng.condition(tokens), prior)
    want = R0.flow_sample(dit, dit.condition(tokens), prior, num_steps=3, guidance_scale=5.0,
                          scale_factor=eng.vae.scale_factor)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert eng.flow_counts() == {"evaluations": 3, "rows": 12, "queries_decoded": 0}
    counts = eng.moe_counts()
    # every call routes each of its 2 x 2 rows' 17 tokens to 2 experts
    assert counts["calls"] == [3, 3]
    assert [sum(row) for row in counts["tokens"]] == [3 * 2 * 4 * 17] * 2


def _step_inputs(bsz, seed):
    rng = np.random.default_rng(seed)
    return dict(
        radar_cube=_tokens(bsz, seed).numpy(), seeds_or_prior=list(range(seed, seed + bsz)),
        q_eval=rng.uniform(-1, 1, (bsz, 512, 3)).astype(np.float32),
        labels=(rng.uniform(size=(bsz, 512)) < 0.2).astype(np.float32),
        helper=rng.uniform(-1, 1, (bsz, 128, 3)).astype(np.float32),
        helper_mask=np.arange(128)[None] < np.array([[100], [128]])[:bsz],
        surface=rng.uniform(-1, 1, (bsz, 400, 3)).astype(np.float32))


@torch.no_grad()
def test_fused_eval_step_matches_reference():
    """The whole eval step at B 2 against the benchmark's plain chain in
    float32 (the same device draws, seeded again): loss, IoU, accuracy,
    the decoded clouds' sizes and Chamfer / F."""
    from rald_bench.reference.chain import occupancy

    eng = _engine()
    dit, vae = _reference(eng)
    vae_sd = eng.vae.state_dict()
    inp = _step_inputs(2, 11)
    prior = eng.draw_prior(inp["seeds_or_prior"], 16, 8, "cpu")
    ev = {**EV, "sampler": {"num_steps": 3, "guidance_scale": 5.0,
                            "scale_factor": eng.vae.scale_factor}}
    lat = R0.flow_sample(dit, dit.condition(torch.as_tensor(inp["radar_cube"])), prior,
                         **ev["sampler"])
    probe = torch.rand(2, 4096, 3, generator=torch.Generator().manual_seed(12)) * 2 - 1
    shift = -float(torch.quantile(vae.decode_queries(vae.decode_latents(lat), probe), 0.8))
    vae_sd["geo_decoder.output_proj.bias"] += shift
    eng.load_state_dicts(vae_state_dict=vae_sd)
    dit, vae = _reference(eng)

    loss, iou, acc, cd, f, n_pred = eng.fused_eval_step(
        inp["radar_cube"], inp["seeds_or_prior"], inp["q_eval"], inp["labels"], None, None,
        torch.Generator().manual_seed(13), inp["helper"], inp["helper_mask"], inp["surface"],
        np.ones((2, 400), bool), compute_cd=True, refine=True, helper_aug=True, use_device_grid=True)
    chain = R0.run_flow_chain(dit, vae, {**inp, "prior": prior.numpy()}, ev,
                              torch.Generator().manual_seed(13))
    r_loss, r_iou, r_acc = occupancy(chain["logits"], torch.as_tensor(inp["labels"]))
    assert float(loss) == pytest.approx(r_loss, rel=1e-5)
    assert (float(iou), float(acc)) == pytest.approx((r_iou, r_acc), abs=1e-6)
    assert 0 < min(chain["n_pred"])
    # a query flips only where its logit lies within the f32 noise of 0
    assert n_pred.tolist() == pytest.approx(chain["n_pred"], abs=2)
    assert cd.tolist() == pytest.approx(chain["cd"], rel=1e-3)
    assert f.tolist() == pytest.approx(chain["f"], abs=5e-3)


@torch.no_grad()
def test_flow_spans_and_counts():
    from torch.profiler import ProfilerActivity, profile

    eng = _engine()
    inp = _step_inputs(1, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.fused_eval_step(
            inp["radar_cube"], inp["seeds_or_prior"], inp["q_eval"], inp["labels"], None, None,
            torch.Generator().manual_seed(1), inp["helper"], inp["helper_mask"], inp["surface"],
            np.ones((1, 400), bool), helper_aug=True)
    names = [e.name[len("rald::"):] for e in prof.events() if e.name.startswith("rald::")]
    steps = CFG["eval"]["inference"]["num_steps"]
    assert names.count("flow_step") == steps
    # one mixture span a mixture and evaluation, its routing inside
    assert names.count("moe") == names.count("moe_route") == 2 * steps
    counts = eng.moe_counts()
    assert counts["calls"] == [steps, steps]
    assert all(sum(row) == steps * 2 * 2 * 17 for row in counts["tokens"])
    assert eng.flow_counts()["rows"] == 2 * steps


@pytest.mark.parametrize("flag", ["eval.inference.int8_ff", "ar_model.overrides.use_fused_attn"])
def test_engine_refuses_kernel_flags(flag):
    with pytest.raises(ValueError, match="no int8 or fused-kernel path: " + flag):
        _engine(**{flag: True})


def test_engine_refuses_what_the_flow_model_lacks():
    eng = _engine()
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.init_state(4, 2)
    with pytest.raises(ValueError, match="capture_states"):
        eng.sample_from_cond(eng.condition(_tokens(1, 0)), [0], capture_states=True)


@torch.no_grad()
def test_flow_sampler_takes_the_graph_path():
    """With the capture stood in (the CPU cannot capture): the 2.1 sampler
    warms, captures and replays through the engine's graph cache; the
    mixtures' counters are in the guard, and a moved weight or counter
    captures anew."""
    eng = _engine()
    eng._sampler_graphs = StandCache("sample_graph", 4)
    cond = eng.condition(_tokens(1, 0))
    outs = [eng.sample_from_cond(cond, [k]) for k in range(3)]
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    for k, out in enumerate(outs):
        prior = eng.draw_prior([k], 16, 8, "cpu")
        assert torch.equal(out, eng._sample_table(prior, cond))
    mix = eng.model.moe_layers()[0]
    assert mix.tokens.data_ptr() in eng._graph_guard()
    mix.tokens = mix.tokens.clone()
    eng.sample_from_cond(cond, [0])
    assert eng.sampler_graph_counts()["captures"] == 2
    lin = eng.model.blocks[2].attn2.to_k
    lin.weight = torch.nn.Parameter(lin.weight.detach() * 0.5)
    eng.sample_from_cond(cond, [0])
    assert eng.sampler_graph_counts()["captures"] == 3


_BENCH = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from rald_bench import readings, run, spec
from rald_torch.train import gen_engine
data = spec.ROOT / "tests" / "data" / "hy3d21"
bench = spec.load_json(data / "bench.json")
real = spec.benchmark()
for key in ("end_to_end", "per_layer"):
    bench[key] = [dict(m, workloads=["tiny_hy3d21_b1"]) for m in real[key]
                  if "eval_hy3d21_live_b1" in m.get("workloads", ["eval_hy3d21_live_b1"])]
cell = spec.cell("tiny_hy3d21_b1", bench, data)
seed = 2 ** 31 + 777
out = {"runs": [run.run(cell, seed, 5.0, trace, device="cpu", log=lambda s: None)
                for trace in (False, True)]}
(line,) = readings.readings(cell, [seed], control=True, int8=False, device="cpu", log=lambda s: None)
out["readings"] = line
gen_engine.GenerationEngine.sample_from_cond = (
    lambda self, cond, prior, capture_states=False:
    torch.as_tensor(np.asarray(prior), device=self.device).float())
out["unchanged"] = run.run(cell, seed, 3.0, False, device="cpu", log=lambda s: None)
print(json.dumps(out, default=str))
"""


def test_bench_cell_runs_and_judges_at_a_tiny_size():
    """The cell's driver, reference and readers through the benchmark's own
    harness at the tiny widths (``tests/data/hy3d21``), in a process of its
    own (the benchmark refuses to run beside JAX): untraced and traced
    runs read correct, the traced one reports the mixtures' metrics that
    the CPU can read, the float8 control fails a limit, and a sampler that
    hands its prior back reads not correct."""
    res = subprocess.run([sys.executable, "-c", _BENCH], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    plain, traced = out["runs"]
    assert plain["correct"] is True and traced["correct"] is True
    assert {"frames_per_s", "frame_ms_p90", "setup_s"} <= set(plain["metrics"])
    for name in ("mfu.moe_dit_sample", "mfu.eval", "sample_ms", "decode_ms", "sample_host_ms",
                 "decode_host_ms", "refine_ms", "chamfer_ms"):
        assert 0 < traced["metrics"][name]["value"], name
    assert traced["metrics"]["moe_load_max_over_mean"]["value"] >= 1.0
    # no kernel runs on the CPU: the grouped kernel's share reads nothing
    assert "roofline.moe_grouped_ffn" not in traced["metrics"]
    limits = json.loads((ROOT / "tests/data/hy3d21/limits/tiny_hy3d21_b1.json").read_text())["limits"]
    line = out["readings"]
    assert all(line["numbers"][n] <= v for n, v in limits.items())
    assert any(line["control"][n] > v for n, v in limits.items())
    assert out["unchanged"]["correct"] is False


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _card_engine(dev, seed=0, **over):
    """bf16, with widths the grouped kernel takes (multiples of 128)."""
    return _engine(dev, **{"system.compute_dtype": "bfloat16", "system.seed": seed,
                           "ar_model.overrides": dict(CFG["ar_model"]["overrides"], hidden_size=256,
                                                      num_heads=2, context_dim=96, n_latents=64,
                                                      num_experts=8, **over)})


def _card_inputs(eng, bsz, seed):
    g = torch.Generator().manual_seed(seed)
    prior = torch.randn(bsz, 64, 8, generator=g)
    return prior, eng.condition(torch.randn(bsz, 32, 96, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [1, 2])
@torch.no_grad()
def test_cuda_flow_graph_matches_eager_bitwise(cuda, bsz):
    """Replays against the eager sampler, bitwise, each call's inputs (and
    so its routing) new; the grouped kernel launches twice a mixture and
    evaluation in the eager call, the capturing call and every replay."""
    from rald_torch.ops import launch_counts, reset_launch_counts

    eng = _card_engine(cuda)
    steps = CFG["eval"]["inference"]["num_steps"]
    prior, cond = _card_inputs(eng, bsz, 100)
    eng.sample_from_cond(cond, prior)  # the key's eager warm-up
    outs = []
    for k in range(3):
        reset_launch_counts()
        prior, cond = _card_inputs(eng, bsz, k)
        outs.append((eng.sample_from_cond(cond, prior), prior, cond))
        assert launch_counts()["moe_grouped_ffn"] == 2 * 2 * steps
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 2, "eager": 1}
    for out, prior, cond in outs:
        assert torch.equal(out, eng._sample_table(prior.to(cuda), cond))
    counts = eng.moe_counts()
    calls = 4 * steps + 3 * steps  # sampler calls, then the eager checks
    assert counts["calls"] == [calls, calls]
    assert all(sum(row) == calls * 2 * bsz * 2 * 65 for row in counts["tokens"])


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_flow_graph_recaptures_on_moved_weights(cuda):
    eng = _card_engine(cuda)
    prior, cond = _card_inputs(eng, 1, 0)
    for _ in range(2):
        eng.sample_from_cond(cond, prior)
    before = eng.sample_from_cond(cond, prior)
    eng.load_state_dicts(edm_state_dict=_card_engine(cuda, seed=1).model.state_dict())
    after = eng.sample_from_cond(cond, prior)
    assert eng.sampler_graph_counts() == {"captures": 2, "replays": 1, "eager": 1}
    assert not torch.equal(after, before)
    assert torch.equal(after, eng._sample_table(prior.to(cuda), cond))
