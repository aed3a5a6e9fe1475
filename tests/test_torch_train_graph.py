"""The stage-2 training step as captured CUDA graphs
(:mod:`rald_torch.train.cuda_graphs`, ``GenerationEngine.train_step``) and
the device-side clip it needs (``rald_torch.train.state.clip_by_global_norm_``).

On the CPU the step never captures; the clip is held bitwise to a host read
of the norm, and the step's keys, guard, draws and host counters are
checked with a stand-in for the capture (``graph_stand``) against the
eager step. The
``gpu`` tests hold the graphs to the eager step, bitwise, on the card
(``python -m pytest -m gpu tests/test_torch_train_graph.py``). This file
imports no JAX: the eager step is the reference.
"""
from __future__ import annotations

import copy
import gc
import weakref

import pytest
import torch

from graph_stand import StandCache
from rald_torch.config import Config
from rald_torch.train import gen_engine
from rald_torch.train.cuda_graphs import GraphCache
from rald_torch.train.gen_engine import GenerationEngine
from rald_torch.train.state import clip_by_global_norm_, global_norm

B = 2
CUBE = (32, 16, 16, 3)
STEPS_PER_EPOCH = 4  # the lr moves every step: warmup over two steps, then the cosine
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
    "train": {"epochs": 2, "lr": 1e-3, "min_lr": 1e-5, "warmup_epochs": 0.5},
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
}
# on the card: bf16 with f32 masters and a working copy, as the product trains
CARD = {"system": {"seed": 0, "compute_dtype": "bfloat16"},
        "overrides": {"n_latents": 64, "channels": 8, "depth": 2, "n_heads": 8, "d_head": 64}}


def _engine(device="cpu", card=False, **train):
    d = copy.deepcopy(CFG)
    if card:
        d["system"] = dict(CARD["system"])
        d["ar_model"]["overrides"] = dict(CARD["overrides"])
    d["train"].update(train)
    return GenerationEngine(Config(d), device=device)


def _batches(eng, n, seed=0):
    """``n`` (latents, cube, draws) on the engine's device; the draws
    injected as the benchmark injects them, on the host."""
    g = torch.Generator().manual_seed(seed)
    m = eng.model
    out = []
    for _ in range(n):
        latents = torch.randn((B, m.n_latents, m.channels), generator=g).to(eng.device)
        cube = torch.randn((B, *CUBE), generator=g).to(eng.device)
        draws = {"rnd": torch.randn((B, 1, 1), generator=g),
                 "noise": torch.randn((B, m.n_latents, m.channels), generator=g)}
        out.append((latents, cube, draws))
    return out


def _run(eng, state, batches, draws="injected"):
    """Steps over ``batches``: the draws injected, or from the step's
    generator as ``train_one_epoch`` seeds it. Returns the (loss,
    grad_norm) of each step."""
    out = []
    for it, (latents, cube, d) in enumerate(batches):
        if draws == "injected":
            _, m = eng.train_step(state, latents, cube, **d)
        else:
            _, m = eng.train_step(state, latents, cube, eng.step_generator(0, it))
        out.append((m["loss"], m["grad_norm"]))
    return out


def _state_tensors(state) -> dict:
    """Everything a step writes: masters, EMA, Adam's moments and steps, the
    working copy."""
    st = state.optimizer.state
    out = {}
    for k, p in state.params.items():
        out[f"param.{k}"] = p
        out[f"ema.{k}"] = state.ema_params[k]
        for s in ("exp_avg", "exp_avg_sq", "step"):
            out[f"{s}.{k}"] = st[p][s]
    for k, w in (state.working or {}).items():
        out[f"working.{k}"] = w
    return out


def _assert_same(a_eng, a_state, a_out, b_eng, b_state, b_out):
    assert len(a_out) == len(b_out)
    for (la, na), (lb, nb) in zip(a_out, b_out):
        assert torch.equal(la, lb) and torch.equal(na, nb)
    ta, tb = _state_tensors(a_state), _state_tensors(b_state)
    assert sorted(ta) == sorted(tb)
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not bad, bad[:5]
    assert (a_state.step, a_state.count) == (b_state.step, b_state.count)


def _clip_between(eng_fn, batches) -> float:
    """A clip between the smallest and the largest unclipped norm of
    ``batches``' steps, so that it acts on some steps and not on others."""
    eng = eng_fn()
    state = eng.init_state(STEPS_PER_EPOCH, B)
    norms = sorted(float(n) for _, n in _run(eng, state, batches))
    return (norms[0] + norms[-1]) / 2


# ---------------------------------------------------------------- CPU
@pytest.mark.parametrize("where", ["above", "at", "below"])
def test_clip_on_device_is_the_host_read_clip(where):
    """``clip_by_global_norm_`` against the clip it replaced (a host read of
    the norm and a branch on it), bitwise, with the norm above, at and
    below the clip."""
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(s, generator=g) for s in ((37, 5), (11,), (3, 4, 2))]
    norm = float(global_norm(grads))
    clip = {"above": norm / 3, "at": norm, "below": norm * 3}[where]
    want = [t.clone() for t in grads]
    if not norm < clip:
        torch._foreach_div_(want, norm)
        torch._foreach_mul_(want, clip)
    got = [t.clone() for t in grads]
    clip_by_global_norm_(got, global_norm(got), clip)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, grads)) == (where == "below")


def _as_if_on_card(eng):
    eng._train_graphs = StandCache("train_graph", 1)
    return eng


@pytest.mark.parametrize("draws", ["injected", "generator"])
def test_graph_path_is_the_eager_step(draws):
    """Through the graph path's host logic (the key's eager warm-up, the
    capture, replays with eager draws, the lr and counters around the
    update), four steps with a clip that acts on some of them give the
    eager step's numbers bitwise."""
    batches = _batches(_engine(), 4)
    clip = _clip_between(_engine, batches)
    runs = []
    for eng in (_as_if_on_card(_engine(clip_grad=clip)), _engine(clip_grad=clip)):
        state = eng.init_state(STEPS_PER_EPOCH, B)
        runs.append((eng, state, _run(eng, state, batches, draws)))
    _assert_same(*runs[0], *runs[1])
    assert runs[0][0].train_graph_counts() == {"captures": 1, "replays": 2, "eager": 1}
    assert runs[1][0].train_graph_counts() == {"captures": 0, "replays": 0, "eager": 4}
    norms = [float(n) for _, n in runs[1][2]]
    assert min(norms) < clip <= max(norms)


@pytest.mark.parametrize("case", ["cpu", "skip_nonfinite", "accum_iter", "process_group"])
def test_steps_that_cannot_replay_run_eagerly(case, monkeypatch):
    """On the CPU, with ``skip_nonfinite_updates`` (a host decision), with
    ``accum_iter > 1`` or under a process group the step runs eagerly and
    counts so, with the eager step's numbers."""
    train = {"skip_nonfinite_updates": True} if case == "skip_nonfinite" else (
        {"accum_iter": 2} if case == "accum_iter" else {})
    if case == "process_group":
        monkeypatch.setattr(gen_engine, "backend", lambda: "gloo")
    batches = _batches(_engine(), 3)
    runs = []
    for eng in (_engine(**train) if case == "cpu" else _as_if_on_card(_engine(**train)),
                _engine(**train)):
        state = eng.init_state(STEPS_PER_EPOCH, B)
        runs.append((eng, state, _run(eng, state, batches)))
    _assert_same(*runs[0], *runs[1])
    assert runs[0][0].train_graph_counts() == {"captures": 0, "replays": 0, "eager": 3}


def test_new_state_or_key_captures_anew():
    """A new train state moves the tensors the graphs read: the guard fails
    and the step is captured anew. Another batch size is another key,
    warmed eagerly first."""
    eng = _as_if_on_card(_engine())
    batches = _batches(eng, 3)
    state = eng.init_state(STEPS_PER_EPOCH, B)
    _run(eng, state, batches)
    (key, first), = eng._train_graphs.entries.items()
    state = eng.init_state(STEPS_PER_EPOCH, B)
    _run(eng, state, batches[:1])
    assert eng._train_graphs.entries[key] is not first
    assert eng.train_graph_counts() == {"captures": 2, "replays": 1, "eager": 1}
    latents, cube, d = batches[0]
    eng.train_step(state, latents[:1], cube[:1], rnd=d["rnd"][:1], noise=d["noise"][:1])
    (new, step), = eng._train_graphs.entries.items()  # the old key's graphs dropped
    assert new != key and step is None and eng.train_graph_counts()["eager"] == 2


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _card_pair(dev, **train):
    """A graphed and an eager engine on the card, each with a fresh state
    from the same weights; the eager one's cache keeps no key, so every
    step is its key's first and runs eagerly."""
    out = []
    for graphed in (True, False):
        eng = _engine(dev, card=True, **train)
        if not graphed:
            eng._train_graphs = GraphCache("train_graph", 0)
        out.append((eng, eng.init_state(STEPS_PER_EPOCH, B)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("draws", ["injected", "generator"])
def test_cuda_graphed_step_matches_eager_bitwise(cuda, draws):
    """Five steps (eager, capture, three replays) with an lr that moves
    every step and a clip that acts on some steps: the loss, the gradient
    norm, masters, EMA, both moments, Adam's steps and the bf16 working
    copy are the eager step's, bitwise."""
    batches = _batches(_engine(cuda, card=True), 5)
    clip = _clip_between(lambda: _engine(cuda, card=True), batches)
    (g_eng, g_state), (e_eng, e_state) = _card_pair(cuda, clip_grad=clip)
    g_out = _run(g_eng, g_state, batches, draws)
    e_out = _run(e_eng, e_state, batches, draws)
    assert g_eng.train_graph_counts() == {"captures": 1, "replays": 3, "eager": 1}
    assert e_eng.train_graph_counts() == {"captures": 0, "replays": 0, "eager": 5}
    assert g_state.capturable and g_state.working
    _assert_same(g_eng, g_state, g_out, e_eng, e_state, e_out)
    norms = [float(n) for _, n in e_out]
    assert min(norms) < clip <= max(norms)


@pytest.mark.gpu
def test_cuda_new_state_captures_anew(cuda):
    """A new train state (new tensors) fails the guard: the step is captured
    anew and stays the eager step's, bitwise. The old captured step,
    still held until then, keeps no old state alive."""
    batches = _batches(_engine(cuda, card=True), 3)
    (g_eng, g_state), (e_eng, e_state) = _card_pair(cuda)
    _run(g_eng, g_state, batches)
    _run(e_eng, e_state, batches)
    old = weakref.ref(g_state)
    g_state, e_state = (e.init_state(STEPS_PER_EPOCH, B) for e in (g_eng, e_eng))
    gc.collect()
    assert old() is None and all(g_eng._train_graphs.entries.values())
    g_out, e_out = _run(g_eng, g_state, batches[:2]), _run(e_eng, e_state, batches[:2])
    assert g_eng.train_graph_counts() == {"captures": 2, "replays": 2, "eager": 1}
    _assert_same(g_eng, g_state, g_out, e_eng, e_state, e_out)


@pytest.mark.gpu
def test_cuda_replays_reach_the_profiler(cuda):
    """Under a profiler the replayed steps' kernels reach the trace, one
    ``rald::train_graph`` range a replay, and ``timings`` gets the replays'
    host ms in the ``forward_backward`` and ``optimizer`` stages."""
    eng = _engine(cuda, card=True)
    batches = _batches(eng, 4)
    state = eng.init_state(STEPS_PER_EPOCH, B)
    _run(eng, state, batches[:2])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _run(eng, state, batches[2:])
        torch.cuda.synchronize()
    host = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert host.count("rald::train_graph") == 4 and "rald::backward" not in host
    assert len(kernels) > 100
    timings = {}
    latents, cube, d = batches[0]
    eng.train_step(state, latents, cube, timings=timings, **d)
    assert {"forward_backward", "optimizer", "train_graph.host"} <= set(timings)
    assert "all_reduce" not in timings
    assert eng.train_graph_counts() == {"captures": 1, "replays": 3, "eager": 1}
