"""``head_rms_norm`` (``rald_torch/ops/head_norm.py``): the RMS QK-norm
of Hunyuan3D-2.1's DiT attentions, over the heads of the q and k
projections' own (B, L, H * Dh) rows.

On the CPU the wrapper is held bitwise to the DiT's composition before the
kernel (a view, a transpose and ``F.rms_norm`` of each of q and k), at
self- and cross-attention shapes, on contiguous rows and on rows that are
a slice of wider ones; its checks raise on what the kernel does not take.
On the card (``-m gpu``) the CUDA kernel, which norms the rows in place,
is held to the plain version at the cell's shapes, to itself from run to
run and inside a CUDA graph, and its launches are counted per DiT
evaluation."""
import pytest
import torch
import torch.nn.functional as F

from rald_torch.models.hunyuan_dit import Hunyuan3DDiTPlain
from rald_torch.ops import head_rms_norm, launch_counts, reset_launch_counts
from rald_torch.ops import head_norm as hrn
from rald_torch.train.gen_engine import init_random_weights

EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _composition(rows, weight, heads):
    """The DiT attention's QK-norm before the kernel: ``_heads`` (a view
    and a transpose to (B, H, L, Dh)), then ``F.rms_norm`` over Dh."""
    b, n, _ = rows.shape
    t = rows.view(b, n, heads, -1).transpose(1, 2)
    return F.rms_norm(t, (t.shape[-1],), weight, EPS)


def _rows(bsz, lq, lk, heads, dh, dtype, device, seed=0, zero_k=0, pad=0):
    """Random q and k rows and weights; the last ``zero_k`` condition
    tokens of k's second batch row zero, as the unconditional row's. With
    ``pad``, the rows are the first ``heads * dh`` channels of rows ``pad``
    channels wider, as a slice of a fused projection's output."""
    g = torch.Generator().manual_seed(seed)
    d = heads * dh
    q = (torch.randn(bsz, lq, d + pad, generator=g) * 3).to(device, dtype)[..., :d]
    k = (torch.randn(bsz, lk, d + pad, generator=g) * 3)
    if zero_k:
        k[-1, -zero_k:] = 0
    weights = [(torch.rand(dh, generator=g) * 2).to(device, dtype) for _ in range(2)]
    return q, k.to(device, dtype)[..., :d], *weights


SHAPES = {"self": (11, 11), "cross": (11, 5)}  # (Lq, Lk)
PADS = {"contiguous": 0, "sliced": 3 * 128}  # channels past the rows' end


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", sorted(PADS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("heads,dh", [(4, 16), (2, 128)], ids=["h4x16", "h2x128"])
def test_plain_twin_is_the_composition_bitwise(shape, rows, dtype, heads, dh):
    lq, lk = SHAPES[shape]
    q, k, wq, wk = _rows(2, lq, lk, heads, dh, dtype, "cpu", zero_k=2, pad=PADS[rows])
    assert q.is_contiguous() == (rows == "contiguous")
    before = (q.clone(), k.clone())
    reset_launch_counts()
    got = head_rms_norm(q, k, wq, wk, heads, EPS)
    assert head_rms_norm.launches == 0  # the CPU takes the plain version
    want = (_composition(q, wq, heads), _composition(k, wk, heads))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t.shape for t in got] == [(2, heads, lq, dh), (2, heads, lk, dh)]
    assert torch.equal(q, before[0]) and torch.equal(k, before[1])  # rows left as they were
    assert not got[1][-1, :, -2:].any()  # zero condition tokens stay zero


def _meta(width=2 * 128, dtype=torch.bfloat16, wdim=128, n=8, grad=False, batch=2):
    rows = torch.empty(batch, n, width, dtype=dtype, device="meta")
    weight = torch.empty(wdim, dtype=dtype, device="meta", requires_grad=grad)
    return rows, weight


@pytest.mark.parametrize("q_kw,k_kw,match", [
    (dict(width=2 * 64), {}, "head width of 128"),
    ({}, dict(wdim=64), "weight"),
    (dict(dtype=torch.float16), dict(dtype=torch.float16), "dtype"),
    (dict(dtype=torch.float32), dict(dtype=torch.float32), "dtype"),
    ({}, dict(batch=3), "batch"),
    ({}, dict(grad=True), "no backward"),
    ({}, {}, "unsupported device"),
], ids=["dh64", "weight64", "fp16", "f32", "batch", "grad", "meta_device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(q_kw, k_kw, match):
    """A tensor off the CPU goes to the kernel or raises: shapes, dtype
    (bf16 alone) and a weight that autograd would need a backward for are
    checked before the device (meta tensors stand in for CUDA ones)."""
    (q, wq), (k, wk) = _meta(**q_kw), _meta(**k_kw)
    with pytest.raises(ValueError, match=match):
        head_rms_norm(q, k, wq, wk, 2, EPS)


def test_check_part_raises_on_bad_strides_and_alignment():
    """Rows need unit stride along a row and 16-byte row steps, and every
    pointer 16-byte alignment."""
    _, w = _meta()
    rows = torch.empty(2, 8, 2 * 128 + 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="rows strides"):
        hrn.check_part(rows[..., :2 * 128], w, heads=2)
    with pytest.raises(ValueError, match="rows strides"):
        hrn.check_part(torch.empty(2, 2 * 128, 8, dtype=torch.bfloat16, device="meta").mT, w, 2)
    hrn.check_part(torch.empty(2, 8, 2 * 128, dtype=torch.bfloat16, device="meta"), w, 2)
    wide = torch.empty(2, 8, 2 * 128 + 8, dtype=torch.bfloat16, device="meta")
    hrn.check_part(wide[..., :2 * 128], w, heads=2)  # a 528-byte row step
    shifted = torch.empty(2 * 8 * 256 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 256)
    with pytest.raises(ValueError, match="aligned"):
        hrn.check_part(shifted, torch.ones(128, dtype=torch.bfloat16), heads=2)


# ---------------------------------------------------------------- card
# the eval_hy3d21_live_b1 cell's attentions: B 2 guidance rows, 16 heads of
# 128, 4097 tokens (the time token and 4096 latents) and 1370 condition
# tokens, the unconditional row's all zero
CELL = dict(bsz=2, heads=16, dh=128)
CARD = {"self": (4097, 4097), "cross": (4097, 1370)}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in units in the last place between same-dtype floats."""
    def ordered(x):
        bits = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).long()
        mag = bits & (0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def _card_call(q, k, wq, wk):
    """The kernel on copies of the rows (laid out as the rows given),
    returning its outputs, views of the copies normed in place, and the
    copies."""
    def copy(t):  # rows of t's row step, sliced to t's width
        b, n, d = t.shape
        wide = torch.empty(b, n, t.stride(1), dtype=t.dtype, device=t.device)
        return wide[..., :d].copy_(t)

    q, k = copy(q), copy(k)
    return head_rms_norm(q, k, wq, wk, CELL["heads"], EPS), (q, k)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", sorted(PADS))
@pytest.mark.parametrize("shape", sorted(CARD))
@torch.no_grad()
def test_kernel_matches_plain_version(cuda, shape, rows):
    """q and k within 1 unit in the last place of bf16 of the plain
    version: each square of a bf16 value is exact in float32, but the
    kernel sums the 128 squares in another order than ``F.rms_norm`` (16
    lanes of 8, then 4 shuffles), which can move the rounded result by one
    unit. Zero condition tokens give zeros. The outputs are views of the
    rows, normed where they lie, also where the rows are a slice of wider
    ones. The kernel repeats itself bitwise, one launch a call."""
    lq, lk = CARD[shape]
    q, k, wq, wk = _rows(CELL["bsz"], lq, lk, CELL["heads"], CELL["dh"], torch.bfloat16, cuda,
                         seed=7, zero_k=300, pad=PADS[rows])
    reset_launch_counts()
    got, normed = _card_call(q, k, wq, wk)
    again, _ = _card_call(q, k, wq, wk)
    torch.cuda.synchronize()
    assert head_rms_norm.launches == 2
    want = (hrn.head_rms_norm_plain(q, wq, CELL["heads"], EPS),
            hrn.head_rms_norm_plain(k, wk, CELL["heads"], EPS))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert int(_ulps(a, b).max()) <= 1
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert not got[1][-1, :, -300:].any()
    for t, r in zip(got, normed):
        assert t.data_ptr() == r.data_ptr() and torch.equal(t, hrn.heads_view(r, CELL["heads"]))


@pytest.mark.gpu
@torch.no_grad()
def test_kernel_in_a_cuda_graph_is_the_eager_call(cuda):
    """A captured call's replay writes bitwise what the eager call wrote."""
    q, k, wq, wk = _rows(CELL["bsz"], *CARD["cross"], CELL["heads"], CELL["dh"], torch.bfloat16,
                         cuda, seed=3, zero_k=300)
    eager, _ = _card_call(q, k, wq, wk)
    static = [q.clone(), k.clone()]
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            got, _ = _card_call(*static, wq, wk)
    torch.cuda.synchronize()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


@pytest.mark.gpu
@torch.no_grad()
def test_kernel_launches_per_evaluation(cuda):
    """One launch an attention, for its q and k: self- and cross-attention
    in each of the 21 blocks, 42 per ``velocity_with_time`` call at the
    published depth (narrow widths, head width 128), so 2100 a 50-step
    sampling, eager and in each replay of the sampler captured as a CUDA
    graph, which gives the eager sampler's bits."""
    from rald_torch.train.cuda_graphs import CapturedGraphs

    dit = Hunyuan3DDiTPlain(in_channels=8, hidden_size=256, context_dim=96, depth=21,
                            num_heads=2, num_moe_layers=6, num_experts=8, n_latents=64,
                            dtype=torch.bfloat16)
    init_random_weights(dit, torch.Generator().manual_seed(0))
    dit = dit.to(cuda, torch.bfloat16).eval()
    x = torch.randn(2, 64, 8, device=cuda)
    c = dit.process_cond(torch.randn(2, 40, 96, device=cuda))
    temb = dit.t_embedder(torch.tensor([0.3], device=cuda))
    reset_launch_counts()
    out = dit.velocity_with_time(x, c, temb)
    torch.cuda.synchronize()
    assert launch_counts()["head_rms_norm"] == 2 * 21 == 42
    assert out.shape == (2, 64, 8) and torch.isfinite(out).all()

    steps = 50
    sample = lambda lat, cond: dit.sample(lat, cond, num_steps=steps)  # noqa: E731
    lat, cond = x[:1], c[:1]
    reset_launch_counts()
    eager = sample(lat, cond)
    assert launch_counts()["head_rms_norm"] == 42 * steps == 2100
    graphs = CapturedGraphs("sample_graph", [sample], guard=())
    for n in (1, 2):  # the first replay captures first
        got = graphs.replay(0, lat, cond)
        torch.cuda.synchronize()
        assert launch_counts()["head_rms_norm"] == (1 + n) * 2100
        assert torch.equal(got, eager)
