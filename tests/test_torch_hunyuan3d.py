"""Hunyuan3D-2.0's shape generator in the port (``rald_torch.models.mmdit``,
``rald_torch.models.shape_vae``, ``rald_torch.diffusion.flow`` and the
engine's flow path), held to the plain float32 reference
(``tests/hunyuan3d_reference.py``) on seeded weights at tiny widths on the
CPU; the published widths' parameter counts on the ``meta`` device; the
benchmark's cell at a tiny size through its own harness; and on the card
(``python -m pytest -m gpu tests/test_torch_hunyuan3d.py``) the graphed
flow sampler against the eager one, bitwise. This file imports no JAX.

Tolerances: both sides compute in float32 on the CPU, so they differ only
where the port sums in another order (``F.scaled_dot_product_attention``
against the written-out softmax, ``addcmul`` against a product and a sum,
the modulation rows of all steps in one product): 1e-6 relative, held at
2e-5. Guided Euler steps multiply a velocity's error by up to ``1 + 2 x
guidance`` each, so the three-step sampler is held at 1e-4."""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hunyuan3d_reference as R
from graph_stand import StandCache
from rald_torch.config import Config
from rald_torch.models.mmdit import Hunyuan3DDiT
from rald_torch.models.registry import get_ae_model, get_generation_model
from rald_torch.models.shape_vae import ShapeVAE
from rald_torch.train.gen_engine import GenerationEngine, init_random_weights

ROOT = Path(__file__).resolve().parent.parent
DIT = dict(in_channels=8, context_in_dim=24, hidden_size=64, num_heads=4, depth=1,
           depth_single_blocks=2)
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
    "ar_model": {"name": "hunyuan3d_dit_v2_0", "configs": {},
                 "overrides": {**DIT, "n_latents": VAE["num_latents"]}},
    "lidar_ae": {"name": "hunyuan3d_vae_v2_0", "latent_std": 1,
                 "overrides": {**VAE, "query_chunk": 4096}},
    "eval": {"fscore_tau": 0.02, "inference": {
        "num_steps": 3, "guidance_scale": 5.0, "num_query_points": 2048,
        "refine_query_aug_num": 1024, "refine_query_scale": 10}},
}
TOL = dict(rtol=2e-5, atol=2e-5)


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
    kw = {k: v for k, v in CFG["ar_model"]["overrides"].items() if k != "n_latents"}
    dit, vae = R.Hunyuan3DDiT(**kw), R.ShapeVAE(**VAE)
    dit.load_state_dict({k: v.float().cpu() for k, v in eng.model.state_dict().items()})
    vae.load_state_dict({k: v.float().cpu() for k, v in eng.vae.state_dict().items()})
    return dit.eval(), vae.eval()


def _pair(kw: dict, seed: int = 0):
    """A port DiT of widths ``kw`` with seeded weights and the reference holding them."""
    port = Hunyuan3DDiT(n_latents=16, **kw)
    init_random_weights(port, torch.Generator().manual_seed(seed))
    ref = R.Hunyuan3DDiT(**kw)
    ref.load_state_dict(port.state_dict())
    return port.eval(), ref.eval()


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("kind", ["double", "single", "final"])
@torch.no_grad()
def test_block_matches_reference(kind):
    port, ref = _pair(DIT)
    g = torch.Generator().manual_seed(1)
    x, c = torch.randn(2, 16, 64, generator=g), torch.randn(2, N_COND, 64, generator=g)
    t = torch.tensor([0.2, 0.9])
    vec = ref.time_in(R.timestep_embedding(t))
    mods = port.mod_rows(t)
    if kind == "double":
        got, want = port.double_blocks[0](x, c, mods[0]), ref.double_blocks[0](x, c, vec)
    elif kind == "single":
        h = torch.cat([c, x], 1)
        got, want = (port.single_blocks[0](h, mods[1]),), (ref.single_blocks[0](h, vec),)
    else:
        got, want = (port.final_layer(x, mods[-1]),), (ref.final_layer(x, vec),)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("kw", [
    DIT,
    dict(in_channels=4, context_in_dim=40, hidden_size=96, num_heads=3, depth=2,
         depth_single_blocks=1, mlp_ratio=2.0, qkv_bias=False),
], ids=["h64_1x2", "h96_2x1_nobias"])
@torch.no_grad()
def test_denoiser_matches_reference(kw):
    port, ref = _pair(kw, seed=3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, kw["in_channels"], generator=g)
    cond = torch.randn(2, N_COND, kw["context_in_dim"], generator=g)
    t = torch.tensor([0.0, 0.48])
    torch.testing.assert_close(port(x, t, cond), ref(x, t, cond), **TOL)


@pytest.mark.parametrize("chunk", [4096, 700], ids=["one_block", "blocks_of_700"])
@torch.no_grad()
def test_decoder_matches_reference(chunk):
    vae = ShapeVAE(**VAE, query_chunk=chunk)
    init_random_weights(vae, torch.Generator().manual_seed(5))
    ref = R.ShapeVAE(**VAE)
    ref.load_state_dict(vae.state_dict())
    g = torch.Generator().manual_seed(6)
    z, q = torch.randn(2, 16, 8, generator=g), torch.rand(2, 3000, 3, generator=g) * 2 - 1
    vae._chunk = lambda b: chunk  # the least block the engine takes is 4096 queries
    got = vae.decode_queries(vae.decode_latents(z), q)[..., 0]
    torch.testing.assert_close(got, ref.decode_queries(ref.decode_latents(z), q, chunk=1000), **TOL)
    assert vae.queries_decoded == 2 * 3000


def test_published_parameter_counts():
    """At the published widths, on the ``meta`` device: the hand counts of
    the benchmark's configuration file."""
    conf = json.loads((ROOT / "rald_bench/configs/hunyuan3d_dit_v2_0.json").read_text())
    with torch.device("meta"):
        dit = get_generation_model("hunyuan3d_dit_v2_0", {})
        vae = get_ae_model("hunyuan3d_vae_v2_0")
    assert sum(p.numel() for p in dit.parameters()) == conf["parameters"]["dit"] == 1113274432
    assert sum(p.numel() for p in vae.parameters()) == conf["parameters"]["vae_decoder"] == 214212865
    pub = conf["published"]
    assert (dit.n_latents, dit.channels, dit.context_in_dim) == (
        pub["vae"]["num_latents"], pub["dit"]["in_channels"], pub["dit"]["context_in_dim"])
    assert (len(dit.double_blocks), len(dit.single_blocks)) == (16, 32)
    assert vae.scale_factor == pub["vae"]["scale_factor"]


# ------------------------------------------------------------ the engine
def _tokens(bsz, seed):
    return torch.randn(bsz, N_COND, DIT["context_in_dim"], generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def test_cfg_sampler_matches_two_call_reference():
    eng = _engine()
    dit, vae = _reference(eng)
    tokens = _tokens(2, 7)
    prior = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(8))
    got = eng.sample_from_cond(eng.condition(tokens), prior)
    want = R.flow_sample(dit, tokens, prior, num_steps=3, guidance_scale=5.0,
                         scale_factor=eng.vae.scale_factor)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert eng.flow_counts() == {"evaluations": 3, "rows": 12, "queries_decoded": 0}
    assert eng.sampler_graph_counts() == {"captures": 0, "replays": 0, "eager": 1}


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
    """The whole eval step at B 2: the loss, IoU and accuracy of the eval
    queries against the reference's sample and decode; the decoded clouds'
    sizes and Chamfer / F against the benchmark's plain chain in float32
    (the same device draws, seeded again), which reaches every stage."""
    from rald_bench.reference import hunyuan3d as bench_ref
    from rald_bench.reference.chain import occupancy

    eng = _engine()
    dit, vae = _reference(eng)
    # the occupancy bias set so that a fifth of the probe decodes positive
    vae_sd = eng.vae.state_dict()
    inp = _step_inputs(2, 11)
    prior = eng.draw_prior(inp["seeds_or_prior"], 16, 8, "cpu")
    lat = R.flow_sample(dit, torch.as_tensor(inp["radar_cube"]), prior, 3, 5.0, eng.vae.scale_factor)
    probe = torch.rand(2, 4096, 3, generator=torch.Generator().manual_seed(12)) * 2 - 1
    shift = -float(torch.quantile(vae.decode_queries(vae.decode_latents(lat), probe), 0.8))
    vae_sd["geo_decoder.output_proj.bias"] += shift
    eng.load_state_dicts(vae_state_dict=vae_sd)
    dit, vae = _reference(eng)

    loss, iou, acc, cd, f, n_pred = eng.fused_eval_step(
        inp["radar_cube"], inp["seeds_or_prior"], inp["q_eval"], inp["labels"], None, None,
        torch.Generator().manual_seed(13), inp["helper"], inp["helper_mask"], inp["surface"],
        np.ones((2, 400), bool), compute_cd=True, refine=True, helper_aug=True, use_device_grid=True)
    logits = vae.decode_queries(vae.decode_latents(lat), torch.as_tensor(inp["q_eval"]))
    r_loss, r_iou, r_acc = occupancy(logits, torch.as_tensor(inp["labels"]))
    assert float(loss) == pytest.approx(r_loss, rel=1e-5)
    assert (float(iou), float(acc)) == pytest.approx((r_iou, r_acc), abs=1e-6)

    lidar, inf = CFG["dataset"]["lidar"], CFG["eval"]["inference"]
    ev = {"device": torch.device("cpu"), "num_query": inf["num_query_points"],
          "helper_num": CFG["dataset"]["query_aug_num"], "helper_scale": 2,
          "refine_num": inf["refine_query_aug_num"], "refine_scale": inf["refine_query_scale"],
          "pc_range": lidar["pc_range"], "voxel_size": lidar["voxel_size"], "fscore_tau": 0.02,
          "view_cone": False,
          "sampler": {"num_steps": 3, "guidance_scale": 5.0, "scale_factor": eng.vae.scale_factor}}
    b_dit, b_vae = bench_ref.Hunyuan3DDiT(**DIT), bench_ref.ShapeVAE(**VAE)
    b_dit.load_state_dict(dit.state_dict())
    b_vae.load_state_dict(vae.state_dict())
    chain = bench_ref.run_flow_chain(b_dit, b_vae, {**inp, "prior": prior.numpy()}, ev,
                                     torch.Generator().manual_seed(13))
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
    assert names.count("dual_stream") == names.count("single_stream") == steps
    # the latent stack, then the keys and values of each of the three decodes
    assert names.count("vae_stack") == 1 + 3
    inf, chunk = CFG["eval"]["inference"], eng.vae._chunk(1)
    grid = inf["num_query_points"] + CFG["dataset"]["query_aug_num"]
    assert names.count("decode_block") == (math.ceil(512 / chunk) + math.ceil(grid / chunk)
                                           + math.ceil(inf["refine_query_aug_num"] / chunk))
    assert eng.flow_counts() == {"evaluations": steps, "rows": 2 * steps,
                                 "queries_decoded": 512 + grid + inf["refine_query_aug_num"]}


@pytest.mark.parametrize("flag", ["eval.inference.int8_ff", "eval.inference.int8_attn",
                                  "ar_model.overrides.use_fused_attn"])
def test_engine_refuses_kernel_flags(flag):
    with pytest.raises(ValueError, match="no int8 or fused-kernel path: " + flag):
        _engine(**{flag: "full" if flag.endswith("int8_attn") else True})


def test_engine_refuses_what_the_flow_model_lacks():
    eng = _engine()
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.init_state(4, 2)
    with pytest.raises(ValueError, match="capture_states"):
        eng.sample_from_cond(eng.condition(_tokens(1, 0)), [0], capture_states=True)


@torch.no_grad()
def test_flow_sampler_takes_the_graph_path():
    """With the capture stood in (the CPU cannot capture): the flow sampler
    warms, captures and replays through the engine's one graph cache, keyed
    by its shapes and settings, and a moved weight captures anew."""
    eng = _engine()
    eng._sampler_graphs = StandCache("sample_graph", 4)
    cond = eng.condition(_tokens(1, 0))
    outs = [eng.sample_from_cond(cond, [k]) for k in range(3)]
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    for k, out in enumerate(outs):
        prior = eng.draw_prior([k], 16, 8, "cpu")
        assert torch.equal(out, eng._sample_table(prior, cond))
    (key,) = eng._sampler_graphs.entries
    assert key[0] == (1, 16, 8) and key[2] == () and ("guidance_scale", 5.0) in key[3]
    lin = eng.model.single_blocks[1].linear2
    lin.weight = torch.nn.Parameter(lin.weight.detach() * 0.5)
    eng.sample_from_cond(cond, [0])
    assert eng.sampler_graph_counts()["captures"] == 2
    assert eng.flow_counts()["evaluations"] == 4 * 3


def test_bench_reference_is_the_test_reference():
    """The benchmark's copy of the reference gives the test reference's
    numbers on the same weights (its fp8 control off)."""
    from rald_bench.reference import hunyuan3d as bench_ref

    torch.manual_seed(0)
    dit, vae = R.Hunyuan3DDiT(**DIT), R.ShapeVAE(**VAE)
    b_dit, b_vae = bench_ref.Hunyuan3DDiT(**DIT), bench_ref.ShapeVAE(**VAE, query_chunk=1000)
    b_dit.load_state_dict(dit.state_dict())
    b_vae.load_state_dict(vae.state_dict())
    g = torch.Generator().manual_seed(2)
    tokens, prior = _tokens(2, 9), torch.randn(2, 16, 8, generator=g)
    with torch.no_grad():
        lat = R.flow_sample(dit, tokens, prior, 3, 5.0, 0.99)
        b_lat = bench_ref.flow_sample(b_dit, b_dit.condition(tokens), prior, 3, 5.0, 0.99)
        q = torch.rand(2, 2500, 3, generator=g) * 2 - 1
        logits = vae.decode_queries(vae.decode_latents(lat), q, chunk=1000)
        b_logits = b_vae.decode_queries(b_vae.decode_latents(b_lat), q)
    assert torch.equal(lat, b_lat) and torch.equal(logits, b_logits)


_BENCH = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from rald_bench import readings, run, spec
from rald_torch.train import gen_engine
data = spec.ROOT / "tests" / "data" / "hy3d"
bench = spec.load_json(data / "bench.json")
real = spec.benchmark()
for key in ("end_to_end", "per_layer"):
    bench[key] = [dict(m, workloads=["tiny_hy3d_b1"]) for m in real[key]
                  if "eval_hy3d_live_b1" in m.get("workloads", ["eval_hy3d_live_b1"])]
cell = spec.cell("tiny_hy3d_b1", bench, data)
seed = 2 ** 31 + 777
out = {"runs": [run.run(cell, seed, 6.0, trace, device="cpu", log=lambda s: None)
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
    harness at the tiny widths (``tests/data/hy3d``), in a process of its
    own (the benchmark refuses to run beside JAX): untraced and traced
    runs read correct, the traced one reports the two new shares, the
    float8 control fails a limit, and a sampler that hands its prior back
    reads not correct."""
    res = subprocess.run([sys.executable, "-c", _BENCH], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    plain, traced = out["runs"]
    assert plain["correct"] is True and traced["correct"] is True
    assert {"frames_per_s", "frame_ms_p90", "setup_s"} <= set(plain["metrics"])
    for name in ("mfu.flow_sample", "mfu.geo_decode", "mfu.eval", "sample_ms", "decode_ms",
                 "sample_host_ms", "decode_host_ms", "refine_ms", "chamfer_ms"):
        assert 0 < traced["metrics"][name]["value"], name
    limits = json.loads((ROOT / "tests/data/hy3d/limits/tiny_hy3d_b1.json").read_text())["limits"]
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


def _card_engine(dev, seed=0):
    """bf16 at head width 64, as the published model's attention runs."""
    return _engine(dev, **{"system.compute_dtype": "bfloat16", "system.seed": seed,
                           "ar_model.overrides": dict(CFG["ar_model"]["overrides"], hidden_size=256,
                                                      context_in_dim=96, n_latents=64)})


def _card_inputs(eng, bsz, seed):
    g = torch.Generator().manual_seed(seed)
    prior = torch.randn(bsz, 64, 8, generator=g)
    return prior, eng.condition(torch.randn(bsz, 32, 96, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [1, 2])
@torch.no_grad()
def test_cuda_flow_graph_matches_eager_bitwise(cuda, bsz):
    eng = _card_engine(cuda)
    prior, cond = _card_inputs(eng, bsz, 100)
    eng.sample_from_cond(cond, prior)  # the key's eager warm-up
    outs = []
    for k in range(3):
        prior, cond = _card_inputs(eng, bsz, k)
        outs.append((eng.sample_from_cond(cond, prior), prior, cond))
        if k == 0:
            first = outs[0][0].clone()
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 2, "eager": 1}
    for out, prior, cond in outs:
        assert torch.equal(out, eng._sample_table(prior.to(cuda), cond))
    assert torch.equal(outs[0][0], first)  # not aliased by the later replays
    assert eng.flow_counts()["rows"] == 4 * 3 * 2 * bsz


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
    lin = eng.model.double_blocks[0].img_mlp[2]
    lin.weight = torch.nn.Parameter(lin.weight.detach() * 0.5)
    moved = eng.sample_from_cond(cond, prior)
    assert eng.sampler_graph_counts()["captures"] == 3
    assert torch.equal(moved, eng._sample_table(prior.to(cuda), cond))


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_flow_sampler_counts_qk_norm_launches(cuda):
    """Each DiT evaluation at the published depths launches the q/k/v split
    kernel once a stream in each of the 16 dual-stream blocks and once in
    each of the 32 single-stream blocks, 64 in all: 3200 a 50-step sample,
    in the key's eager call, its capturing call and its replays."""
    from rald_torch.ops import launch_counts, reset_launch_counts

    eng = _engine(cuda, **{"system.compute_dtype": "bfloat16", "eval.inference.num_steps": 50,
                           "ar_model.overrides": dict(CFG["ar_model"]["overrides"], hidden_size=256,
                                                      context_in_dim=96, n_latents=64, depth=16,
                                                      depth_single_blocks=32)})
    prior, cond = _card_inputs(eng, 1, 0)
    for _ in range(3):
        reset_launch_counts()
        eng.sample_from_cond(cond, prior)
        torch.cuda.synchronize()
        assert launch_counts()["split_qk_norm"] == (2 * 16 + 32) * 50 == 3200
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
