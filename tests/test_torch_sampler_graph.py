"""The no-churn sampler as captured CUDA graphs
(:mod:`rald_torch.train.cuda_graphs`, ``GenerationEngine.sample_from_cond``).

On the CPU the sampler never captures; the cache's keys, guard and
invalidation, for the sampler's configuration and the training step's, are
checked there with a stand-in for the capture (``graph_stand``). The ``gpu``
tests hold the graphs to the eager sampler, bitwise, on the card
(``python -m pytest -m gpu tests/test_torch_sampler_graph.py``). This file
imports no JAX: the eager sampler is the reference.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from rald_torch.config import Config
from rald_torch.diffusion.edm import edm_sampler, unstack_mods
from graph_stand import StandCache
from rald_torch.ops import launch_counts, reset_launch_counts
from rald_torch.train.gen_engine import GenerationEngine

CFG = {
    "system": {"seed": 0, "compute_dtype": "float32"},
    "dataset": {
        "lidar": {
            "pc_range": [0, -90, -20, 15.8, 90, 20], "voxel_size": [0.05, 0.25, 0.5],
            "num_samples": 512, "norm_isotropy": False, "norm_anisotropy": True,
            "view_cone_mode": True,
        },
        "radar": {"input_r_dim": 32, "input_a_dim": 16, "input_e_dim": 16, "input_ch": 3,
                  "upsample": False},
    },
    "ar_model": {
        "name": "kl_d512_m512_l32_d24_edm",
        "configs": {
            "cond_type": "radar", "use_radar_cond": True, "use_radar_enc": True,
            "unfreeze_radar_enc": True, "radar_token_channel": 32,
            "enc_radar_r_dim": 2, "enc_radar_a_dim": 1, "enc_radar_e_dim": 1,
            "enc_radar_ch": 4, "enc_hidden_ch": 8,
        },
        "overrides": {"n_latents": 16, "channels": 8, "depth": 2, "n_heads": 2, "d_head": 16},
    },
    "lidar_ae": {
        "name": "kl_d512_m512_l32_mix", "latent_std": 1,
        "overrides": {"dim": 64, "queries_dim": 64, "depth": 2, "num_latents": 16,
                      "latent_dim": 8, "heads": 4, "dim_head": 16},
    },
    "eval": {"inference": {"num_steps": 4}},
}
# the card's kernels take the product's width (D = 512, head dim 64)
CARD = {"system": {"seed": 0, "compute_dtype": "bfloat16"},
        "overrides": {"n_latents": 64, "channels": 8, "depth": 2, "n_heads": 8, "d_head": 64}}


def _engine(device="cpu", seed=0, inference=None, card=False, **system):
    d = copy.deepcopy(CFG)
    if card:
        d["system"] = dict(CARD["system"])
        d["ar_model"]["overrides"] = dict(CARD["overrides"])
        d["eval"]["inference"] = {}
    d["system"].update(system, seed=seed)
    d["eval"]["inference"].update(inference or {})
    return GenerationEngine(Config(d), device=device)


def _inputs(eng, bsz, seed):
    """An injected prior and the condition tokens of a random cube."""
    g = torch.Generator().manual_seed(seed)
    m = eng.model
    prior = torch.randn((bsz, m.n_latents, m.channels), generator=g)
    cube = torch.randn((bsz, 32, 16, 16, 3), generator=g)
    return prior, eng.condition(cube.numpy())


def _reference(eng, prior, cond):
    """The no-churn sampler as it ran before graphs: ``edm_sampler`` over
    the schedule's mod table."""
    m = eng.model
    _, table = eng._schedule()
    return edm_sampler(
        lambda x, sigma, idx: m.denoise_with_mods(x, sigma, unstack_mods(table[idx]), cond),
        prior.to(eng.device).float(), **eng.sampler_kwargs)


def _as_if_on_card(eng):
    eng._sampler_graphs = StandCache("sample_graph", 4)
    return eng


# ---------------------------------------------------------------- CPU
@torch.no_grad()
def test_cpu_never_captures_and_keeps_its_tokens():
    eng = _engine()
    for k in range(3):
        prior, cond = _inputs(eng, 2, k)
        assert torch.equal(eng.sample_from_cond(cond, prior), _reference(eng, prior, cond))
    tokens, (idxs, xs) = eng.sample_from_cond(cond, prior, capture_states=True)
    assert torch.equal(tokens, _reference(eng, prior, cond)) and len(idxs) == 7
    assert eng.sampler_graph_counts() == {"captures": 0, "replays": 0, "eager": 4}
    assert all(g is None for g in eng._sampler_graphs.entries.values())


@torch.no_grad()
def test_cpu_churn_counts_eager():
    eng = _engine(inference={"s_churn": 1.0})
    _, cond = _inputs(eng, 1, 0)
    eng.sample_from_cond(cond, [3])
    assert eng.sampler_graph_counts() == {"captures": 0, "replays": 0, "eager": 1}


@pytest.mark.parametrize("name, max_keys", [("sample_graph", 4), ("train_graph", 1)])
def test_cache_warms_captures_replays_and_evicts(name, max_keys):
    """The sampler's configuration keeps four keys, least recently used
    dropped first; the training step's one, dropped on a new key."""
    graphs = StandCache(name, max_keys)
    fn = lambda x, c: x + 1  # noqa: E731
    x = torch.zeros(2)

    def call(key, guard):  # as the engine calls the cache
        g = graphs.lookup(key, guard, (fn,))
        return graphs.eager(fn, x, None) if g is None else g.replay(0, x, None)

    assert torch.equal(call("a", (1,)), x + 1)
    assert graphs.entries["a"] is None  # warmed: the first call runs eagerly
    call("a", (1,))
    first = graphs.entries["a"]
    call("a", (1,))
    assert graphs.entries["a"] is first and first.replays == 2
    assert graphs.counts == {"captures": 1, "replays": 1, "eager": 1}
    call("a", (2,))  # a tensor moved: captured anew
    assert graphs.entries["a"] is not first and graphs.counts["captures"] == 2
    keys = "bcde"[:max_keys]
    for key in keys:  # the last key drops the least recently used, "a"
        call(key, (1,))
    assert list(graphs.entries) == list(keys) and graphs.counts["eager"] == 1 + max_keys
    call(keys[0], (1,))
    graphs.clear()
    assert list(graphs.entries) == list(keys[1:] + keys[0]) and graphs.entries[keys[0]] is None
    call(keys[0], (1,))  # still warm: captures at once
    assert graphs.counts == {"captures": 4, "replays": 1, "eager": 1 + max_keys}


@torch.no_grad()
def test_engine_graph_path_keys_and_results():
    eng = _as_if_on_card(_engine())
    outs = []
    for k in range(3):
        prior, cond = _inputs(eng, 1, k)
        outs.append((eng.sample_from_cond(cond, prior), _reference(eng, prior, cond)))
    assert all(torch.equal(a, b) for a, b in outs)
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    prior, cond = _inputs(eng, 2, 5)  # another batch: another key, warmed eagerly
    eng.sample_from_cond(cond, prior)
    assert eng.sampler_graph_counts()["eager"] == 2 and len(eng._sampler_graphs.entries) == 2
    keys = list(eng._sampler_graphs.entries)
    assert keys[0][0] == (1, 16, 8) and keys[1][0] == (2, 16, 8)
    eng.sample_from_cond(None, prior)  # no condition tokens: a key of its own
    assert list(eng._sampler_graphs.entries)[-1][1] is None


@pytest.mark.parametrize("change", ["load_state_dicts", "set_flags", "set_int8", "new_tensor"])
@torch.no_grad()
def test_engine_drops_stale_graphs(change):
    """Loading weights drops the DiT's graphs; a flag the modes carry is a
    new key; re-quantizing or a parameter replaced by a new tensor moves
    the guard."""
    eng = _as_if_on_card(_engine(inference={"int8_ff": True}))
    prior, cond = _inputs(eng, 1, 0)
    for _ in range(2):
        eng.sample_from_cond(cond, prior)
    graphs = eng._sampler_graphs
    (key, first), = graphs.entries.items()
    assert first is not None and graphs.counts["captures"] == 1
    m = eng.model
    if change == "load_state_dicts":
        new = _engine(seed=1).model.state_dict()
        eng.load_state_dicts(edm_state_dict=new)
        assert graphs.entries[key] is None
    elif change == "set_flags":
        m.set_flags(use_fused_ff=not m.use_fused_ff)
        eng.sample_from_cond(cond, prior)  # a new key, warmed eagerly
        *_, new = graphs.entries
        assert new != key and graphs.entries[key] is first and graphs.counts["eager"] == 2
        key = new
    elif change == "set_int8":
        eng._quantize(m.state_dict())
        assert eng._graph_guard() != first.guard
    else:
        blk = m.model.transformer_blocks[0].ff.proj_in
        blk.weight = torch.nn.Parameter(blk.weight.detach().clone())
    out = eng.sample_from_cond(cond, prior)
    assert graphs.entries[key] is not first and graphs.counts["captures"] == 2
    assert torch.equal(out, _reference(eng, prior, cond))


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _card_engine(dev, seed=0, inference=None):
    return _engine(dev, seed=seed, inference=inference, card=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [1, 2])
@torch.no_grad()
def test_cuda_graph_matches_eager_bitwise(cuda, bsz):
    eng = _card_engine(cuda)
    prior, cond = _inputs(eng, bsz, 100)
    eng.sample_from_cond(cond, prior)  # the key's eager warm-up
    reset_launch_counts()
    outs = []
    for k in range(3):
        prior, cond = _inputs(eng, bsz, k)
        outs.append((eng.sample_from_cond(cond, prior), prior, cond))
        if k == 0:
            first = outs[0][0].clone()
    graphed = launch_counts()
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 2, "eager": 1}
    reset_launch_counts()
    for out, prior, cond in outs:
        assert torch.equal(out, eng._sample_table(prior.to(cuda), cond))
    assert launch_counts() == graphed and graphed["fused_ln_geglu_residual"] == 3 * 35 * 2
    assert torch.equal(outs[0][0], first)  # not aliased by the later replays


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_graph_recaptures_on_new_weights(cuda):
    eng = _card_engine(cuda)
    prior, cond = _inputs(eng, 1, 0)
    for _ in range(2):
        eng.sample_from_cond(cond, prior)
    before = eng.sample_from_cond(cond, prior)
    other = _card_engine(cuda, seed=1)
    eng.load_state_dicts(edm_state_dict=other.model.state_dict())
    after = eng.sample_from_cond(cond, prior)
    assert eng.sampler_graph_counts() == {"captures": 2, "replays": 1, "eager": 1}
    assert not torch.equal(after, before)
    assert torch.equal(after, eng._sample_table(prior.to(cuda), cond))
    blk = eng.model.model.transformer_blocks[1].ff.proj_out
    blk.weight = torch.nn.Parameter(blk.weight.detach() * 0.5)
    moved = eng.sample_from_cond(cond, prior)
    assert eng.sampler_graph_counts()["captures"] == 3
    assert torch.equal(moved, eng._sample_table(prior.to(cuda), cond))


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_graph_int8_static_vout_matches_eager(cuda, tmp_path):
    rng = np.random.default_rng(0)
    npz = tmp_path / "scales.npz"
    np.savez(npz, ah=rng.uniform(3, 6, (18, 2)).astype(np.float32),
             ag=rng.uniform(1, 3, (18, 2)).astype(np.float32), num_steps=18)
    eng = _card_engine(cuda, inference={"int8_ff": "static", "int8_attn": "vout",
                                        "int8_act_scales": str(npz)})
    outs = []
    for k in range(3):
        prior, cond = _inputs(eng, 2, k)
        outs.append((eng.sample_from_cond(cond, prior), prior, cond))
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    reset_launch_counts()
    for out, prior, cond in outs:
        assert torch.equal(out, eng._sample_table(prior.to(cuda), cond))
    n = launch_counts()
    assert n["fused_ln_geglu_residual_int8_static"] == 3 * 35 * 2
    assert n["fused_self_attention_block_int8_vout"] == 3 * 35 * 2


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_churn_and_capture_states_run_eager(cuda):
    eng = _card_engine(cuda, inference={"s_churn": 1.0})
    _, cond = _inputs(eng, 1, 0)
    for _ in range(3):
        eng.sample_from_cond(cond, [7])
    plain = _card_engine(cuda)
    prior, cond = _inputs(plain, 1, 0)
    for _ in range(2):
        plain.sample_from_cond(cond, prior, capture_states=True)
    assert eng.sampler_graph_counts() == {"captures": 0, "replays": 0, "eager": 3}
    assert plain.sampler_graph_counts() == {"captures": 0, "replays": 0, "eager": 2}


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_graph_captures_and_replays_under_the_profiler(cuda):
    """An operator's trace (``maybe_trace``) around the dataset loop may
    hold a capture: it still gives the eager bits, and the replays' kernels
    reach the trace."""
    eng = _card_engine(cuda)
    prior, cond = _inputs(eng, 1, 0)
    eng.sample_from_cond(cond, prior)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        outs = [eng.sample_from_cond(cond, prior) for _ in range(2)]
        torch.cuda.synchronize()
    assert eng.sampler_graph_counts() == {"captures": 1, "replays": 1, "eager": 1}
    want = eng._sample_table(prior.to(cuda), cond)
    assert all(torch.equal(o, want) for o in outs)
    host = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert host.count("rald::sample_graph") == 2 and host.count("rald::nfe") == 35
    assert sum("gemm_kernel" in n for n in kernels) >= 2 * 35 * 2  # the FF kernel, twice a block
