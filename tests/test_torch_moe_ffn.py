"""The mixture-of-experts feed-forward of Hunyuan3D-2.1's DiT
(``rald_torch.models.moe``) and its grouped expert kernel
(``rald_torch.ops.moe_grouped_ffn``).

On the CPU: the plain version of the grouped feed-forward against each
row's own expert computed alone, the device-routed layer against the
public code's host-routed loop (``rald_bench.reference.hunyuan3d_v2_1``)
under ordinary routings and under one where one expert takes every token
and another none, its counters, spans and stacked weights. On the card
(``python -m pytest -m gpu tests/test_torch_moe_ffn.py``): the kernel
against its plain version, and the layer captured in a CUDA graph against
eager, bitwise, with the same two launches a call under any routing.

Tolerances: on the CPU both sides compute in float32 and differ in the
order of their sums (the stacked rows' GEMMs against per-token products,
the softmax in float32 of float32 logits on both sides): 1e-5 relative.
On the card, bf16: the kernel and its plain version round at the same four
points and sum in f32 in different orders, so a hidden activation may land
one bf16 ulp (2^-8 relative) apart; their outputs are held at 4e-3 in
relative norm."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rald_bench.reference import hunyuan3d_v2_1 as R
from rald_torch.models.moe import MoEFFN
from rald_torch.ops import moe_ffn as mf
from rald_torch.train.gen_engine import init_random_weights

D, INNER, E = 32, 64, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _mix(seed=0, dim=D, inner=INNER, experts=E, top_k=2):
    mix = MoEFFN(dim, inner, experts, top_k)
    init_random_weights(mix, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in mix.modules():  # biases drawn too, so every term is seen
            if isinstance(m, torch.nn.Linear) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen))
    return mix.eval()


def _skewed(mix, gen):
    """Rows with a positive mean and a gate whose expert 1 scores every row
    highest and expert 2 none: expert 1 takes every token, expert 2 none."""
    h = torch.randn(40, D, generator=gen) + 3.0
    with torch.no_grad():
        mix.gate.weight[1] = 0.3
        mix.gate.weight[2] = -0.3
    return h


def _routed(counts, gen, dim=D):
    n = sum(counts)
    rows = torch.randn(n, dim, generator=gen)
    gate = torch.rand(n, generator=gen)
    off = torch.tensor([0, *np.cumsum(counts).tolist()], dtype=torch.int32)
    return rows, gate, off


ROUTINGS = {"spread": [5, 9, 1, 7], "one_empty": [6, 0, 11, 3], "one_takes_all": [0, 0, 23, 0]}


@pytest.mark.parametrize("counts", ROUTINGS.values(), ids=ROUTINGS.keys())
@torch.no_grad()
def test_plain_grouped_ffn_is_each_rows_expert(counts):
    mix = _mix()
    rows, gate, off = _routed(counts, torch.Generator().manual_seed(1))
    got = mf.moe_grouped_ffn(rows, off, mix.w1, mix.b1, mix.w2, mix.b2, gate)
    expert = torch.repeat_interleave(torch.arange(E), torch.tensor(counts))
    for r in range(len(rows)):
        want = gate[r] * mix.experts[int(expert[r])](rows[r:r + 1])[0]
        torch.testing.assert_close(got[r], want, **TOL)


def _reference_of(mix):
    ref = R.MoEBlock(D, INNER, E, mix.top_k)
    ref.load_state_dict(mix.state_dict())
    return ref.eval()


@pytest.mark.parametrize("kind", ["normal", "skewed"])
@torch.no_grad()
def test_layer_matches_the_host_routed_loop(kind):
    mix = _mix(2)
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(2, 20, D, generator=gen) if kind == "normal" else _skewed(mix, gen).view(2, 20, D)
    got = mix(h)
    torch.testing.assert_close(got, _reference_of(mix)(h), **TOL)
    counts = mix.tokens.tolist()
    assert sum(counts) == 2 * 40 and int(mix.calls) == 1
    if kind == "skewed":
        assert counts[1] == 40 and counts[2] == 0


@torch.no_grad()
def test_counters_spans_and_stacked_weights():
    from torch.profiler import ProfilerActivity, profile

    mix = _mix(4, top_k=3)
    h = torch.randn(3, 7, D, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            mix(h)
    names = [e.name for e in prof.events() if e.name.startswith("rald::")]
    assert names.count("rald::moe") == names.count("rald::moe_route") == 2
    assert sum(mix.tokens.tolist()) == 2 * 3 * 3 * 7 and int(mix.calls) == 2
    # the experts' parameters stay views into the stacks through a cast
    mix = mix.to(torch.float64)
    for i, ex in enumerate(mix.experts):
        assert ex.net[0].proj.weight.data_ptr() == mix.w1[i].data_ptr()
        assert ex.net[2].bias.data_ptr() == mix.b2[i].data_ptr()
    sd = {k: v.clone() * 2 for k, v in mix.state_dict().items()}
    mix.load_state_dict(sd)
    assert torch.equal(mix.w2[1], sd["experts.1.net.2.weight"])
    assert mix.tokens.dtype == torch.int64 and "tokens" not in mix.state_dict()


def test_top_k_must_fit_the_experts():
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(D, INNER, 2, 3)


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


CARD = dict(dim=256, inner=512, experts=8)


def _card_mix(dev, seed=0):
    return _mix(seed, **CARD).to(device=dev, dtype=torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [[130, 0, 257, 1, 128, 64, 300, 100], [0] * 5 + [1000, 0, 0],
                                    [1] * 8], ids=["spread_one_empty", "one_takes_all", "ones"])
@torch.no_grad()
def test_cuda_kernel_matches_plain(cuda, counts):
    mix = _card_mix(cuda)
    rows, gate, off = _routed(counts, torch.Generator().manual_seed(7), CARD["dim"])
    rows, gate, off = rows.to(cuda, torch.bfloat16), gate.to(cuda), off.to(cuda)
    w = (mix.w1, mix.b1, mix.w2, mix.b2)
    before = mf.moe_grouped_ffn.launches
    got = mf.moe_grouped_ffn(rows, off, *w, gate)
    assert mf.moe_grouped_ffn.launches - before == 2
    want = mf.moe_grouped_ffn_plain(rows, off, *w, gate)
    assert torch.isfinite(got).all()
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= 4e-3, rel


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_cannot_take(cuda):
    mix = _card_mix(cuda)
    rows, gate, off = _routed([4] * 8, torch.Generator().manual_seed(0), CARD["dim"])
    w = (mix.w1, mix.b1, mix.w2, mix.b2)
    with pytest.raises(ValueError, match="bfloat16"):
        mf.moe_grouped_ffn(rows.to(cuda), off.to(cuda), *w, gate.to(cuda))
    with pytest.raises(ValueError, match="int32"):
        mf.moe_grouped_ffn(rows.to(cuda, torch.bfloat16), off.to(cuda).long(), *w, gate.to(cuda))


@pytest.mark.gpu
@torch.no_grad()
def test_cuda_graph_replay_matches_eager_bitwise(cuda):
    """The layer captured in a CUDA graph: every replay, whatever its
    routing, gives the eager call's bits and launches the kernel twice, and
    the counters add the routed tokens on every replay."""
    mix = _card_mix(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    inputs = [torch.randn(2, 300, CARD["dim"], generator=gen, device=cuda).bfloat16()
              for _ in range(3)]
    inputs.append(inputs[0] + 4.0)  # another routing
    static = inputs[0].clone()
    mix(static)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = mf.moe_grouped_ffn.launches
    with torch.cuda.graph(graph):
        out = mix(static)
    assert mf.moe_grouped_ffn.launches - before == 2
    mix.tokens.zero_()
    mix.calls.zero_()
    for x in inputs:
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, mix(x))
    assert int(mix.calls) == 2 * len(inputs)
    assert sum(mix.tokens.tolist()) == 2 * len(inputs) * 2 * 600
