"""``split_qk_norm`` (``rald_torch/ops/qk_norm.py``): the q / k / v split,
RMS QK-norm and joint layout of Hunyuan3D's DiT blocks.

On the CPU the wrapper's plain version is held bitwise to the DiT's own
composition before the kernel (a view, a permute, ``F.rms_norm`` on q and
k, and, in a dual-stream block, three ``torch.cat``), in both layouts: two
streams joined at offsets 0 and ``n_c``, and one stream read as the
strided qkv slice of a single-stream block's ``linear1`` rows. On the card
(``-m gpu``) the CUDA kernel is held to the plain version at the published
model's shapes, to itself from run to run, and its launches are counted per
DiT evaluation."""
import pytest
import torch
import torch.nn.functional as F

from rald_torch.models.mmdit import Hunyuan3DDiT
from rald_torch.ops import launch_counts, qk_norm, reset_launch_counts, split_qk_norm
from rald_torch.train.gen_engine import init_random_weights

EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _split_qkv_then_cat(parts, heads):
    """The DiT blocks' composition before the kernel: each stream's
    ``split_qkv`` (view, permute, unbind, ``F.rms_norm`` of q and k with the
    stream's scales), then, for two streams, ``torch.cat`` of q, k and v."""
    outs = []
    for qkv, q_scale, k_scale in parts:
        b, n, _ = qkv.shape
        q, k, v = qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
        outs.append((F.rms_norm(q, (q.shape[-1],), q_scale, EPS),
                     F.rms_norm(k, (k.shape[-1],), k_scale, EPS), v))
    if len(outs) == 1:
        return outs[0]
    (cq, ck, cv), (xq, xk, xv) = outs
    return torch.cat([cq, xq], 2), torch.cat([ck, xk], 2), torch.cat([cv, xv], 2)


def _parts(layout, bsz, lens, heads, dh, dtype, device, seed=0, mlp=0):
    """Random qkv rows and scales per stream. ``single``: one stream, the
    qkv slice of ``[qkv | mlp]`` rows (row stride ``3 D + mlp``)."""
    g = torch.Generator().manual_seed(seed)
    d = heads * dh
    parts = []
    for n in lens:
        rows = torch.randn(bsz, n, 3 * d + mlp, generator=g) * 3
        qkv = rows.to(device, dtype)[..., :3 * d] if layout == "single" else rows.to(device, dtype)
        scales = [(torch.rand(dh, generator=g) * 2).to(device, dtype) for _ in range(2)]
        parts.append((qkv, *scales))
    return parts


LAYOUTS = {
    # (lens, mlp): two streams at offsets 0 and n_c; one strided linear1 slice
    "dual": ((5, 11), 0),
    "single": ((16,), 48),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("heads,dh", [(4, 16), (2, 64)], ids=["h4x16", "h2x64"])
def test_plain_twin_is_the_composition_bitwise(layout, dtype, heads, dh):
    lens, mlp = LAYOUTS[layout]
    parts = _parts(layout, 2, lens, heads, dh, dtype, "cpu", mlp=mlp)
    if layout == "single":
        assert not parts[0][0].is_contiguous()
    reset_launch_counts()
    got = split_qk_norm(parts, heads, EPS)
    assert split_qk_norm.launches == 0  # the CPU takes the plain version
    want = _split_qkv_then_cat(parts, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    n_tot = sum(lens)
    assert [t.shape for t in got] == [(2, heads, n_tot, dh)] * 3
    if layout == "single":  # v stays a view of the rows
        assert got[2].data_ptr() == parts[0][0].data_ptr() + 2 * heads * dh * dtype.itemsize


def _meta_part(width=3 * 2 * 64, dtype=torch.bfloat16, scale_dim=64, n=8, grad=False):
    qkv = torch.empty(2, n, width, dtype=dtype, device="meta")
    scale = torch.empty(scale_dim, dtype=dtype, device="meta", requires_grad=grad)
    return qkv, scale, scale


@pytest.mark.parametrize("bad,match", [
    (dict(width=3 * 2 * 32), "head width of 64"),
    (dict(width=3 * 2 * 64, scale_dim=32), "scales"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(grad=True), "no backward"),
    (dict(), "unsupported device"),
], ids=["dh32", "scale32", "fp16", "grad", "meta_device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, match):
    """A tensor off the CPU goes to the kernel or raises: shapes, dtype and
    a scale that autograd would need a backward for are checked before the
    device (meta tensors stand in for CUDA ones)."""
    with pytest.raises(ValueError, match=match):
        split_qk_norm([_meta_part(**bad)], 2, EPS)


@pytest.mark.parametrize("offset,n_tot", [(-1, 8), (1, 8), (0, 7)], ids=["neg", "past", "short"])
def test_check_part_raises_on_a_bad_offset(offset, n_tot):
    with pytest.raises(ValueError, match="outside"):
        qk_norm.check_part(*_meta_part(), heads=2, n_tot=n_tot, offset=offset)
    qk_norm.check_part(*_meta_part(), heads=2, n_tot=9, offset=1)


def test_check_part_raises_on_unaligned_row_steps():
    rows = torch.empty(2, 8, 3 * 2 * 64 + 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="strides"):
        qk_norm.check_part(rows[..., :3 * 2 * 64], *_meta_part()[1:], heads=2, n_tot=8, offset=0)


# ---------------------------------------------------------------- card
# the published model's attention: B 2 guidance rows, 1370 condition and
# 3072 latent tokens, 16 heads of 64, [qkv | 4096-wide MLP] single-stream rows
CELL = dict(bsz=2, heads=16, dh=64)
CARD = {"dual": ((1370, 3072), 0), "single": ((4442,), 4096)}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in units in the last place between same-dtype floats."""
    def ordered(x):
        bits = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).long()
        mag = bits & (0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", sorted(CARD))
@torch.no_grad()
def test_kernel_matches_plain_version(cuda, layout, dtype):
    """q and k within 1 unit in the last place of bf16 (16 of float32) of
    the plain version: each square of a bf16 value is exact in float32, but
    the kernel sums the 64 squares in another order than ``F.rms_norm``
    (8 lanes of 8, then 3 shuffles), which can move the rounded result by
    one unit; in float32 the squares and products round too. v is copied,
    bitwise. The kernel repeats itself bitwise."""
    lens, mlp = CARD[layout]
    parts = _parts(layout, CELL["bsz"], lens, CELL["heads"], CELL["dh"], dtype, cuda, seed=7,
                   mlp=mlp)
    reset_launch_counts()
    got = split_qk_norm(parts, CELL["heads"], EPS)
    again = split_qk_norm(parts, CELL["heads"], EPS)
    torch.cuda.synchronize()
    assert split_qk_norm.launches == 2 * len(lens)
    want = qk_norm.split_qk_norm_plain(parts, CELL["heads"], EPS)
    tol = 1 if dtype == torch.bfloat16 else 16
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape == (CELL["bsz"], CELL["heads"], sum(lens), CELL["dh"])
        assert int(_ulps(a, b).max()) <= tol
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@torch.no_grad()
def test_kernel_launches_per_evaluation(cuda):
    """One launch a stream in each dual-stream block and one in each
    single-stream block: 2 x 16 + 32 = 64 per ``velocity_with_mods`` call
    at the published depths (narrow widths, head width 64)."""
    dit = Hunyuan3DDiT(in_channels=8, context_in_dim=32, hidden_size=256, num_heads=4, depth=16,
                       depth_single_blocks=32, n_latents=64, dtype=torch.bfloat16)
    init_random_weights(dit, torch.Generator().manual_seed(0))
    dit = dit.to(cuda, torch.bfloat16).eval()
    x = torch.randn(2, 64, 8, device=cuda)
    c = dit.process_cond(torch.randn(2, 40, 32, device=cuda))
    mods = dit.mod_rows(torch.tensor([0.3], device=cuda))
    reset_launch_counts()
    out = dit.velocity_with_mods(x, c, mods)
    torch.cuda.synchronize()
    assert launch_counts()["split_qk_norm"] == 2 * 16 + 32 == 64
    assert out.shape == (2, 64, 8) and torch.isfinite(out).all()
