"""``fused_self_attention_block``: the port's plain version against
rald_tpu's Pallas kernel (interpret mode) in float32 and bfloat16, AdaLN
and affine mod, ragged token counts; the wrapper's CPU dispatch and checks;
and -- on the card only -- the CUDA kernel against its plain version. The
DiT and the sampler with ``use_fused_attn`` are held against JAX in
``test_torch_dit.py`` and ``test_torch_sampler.py``.

Bar 5e-3 * max|out| against Pallas (measured far below it: the two sides
differ only by f32 summation order, and in bf16 by the roundings that
follow from it); 2e-2 * max|out| for the bf16 CUDA kernel, whose 512-term
sums run in another order than the plain version's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.ops import attn_kernel as ta


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu` on the card")
    return torch.device("cuda")


def _inputs(bsz, n, d, adaln, seed):
    """x, scale, shift, wq, wk, wv, wo (torch layout), bo as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.normal(size=shape) * std).astype(np.float32)
    x = f(bsz, n, d)
    if adaln:  # one AdaLN row per batch element
        s, b = f(bsz, 1, d, std=0.5), f(bsz, 1, d, std=0.1)
    else:  # affine LayerNorm weight and bias
        s, b = 1.0 + f(d, std=0.1), f(d, std=0.1)
    return [x, s, b] + [f(d, d, std=d ** -0.5) for _ in range(4)] + [f(d, std=0.5)]


def _pallas(args, heads, adaln, dtype):
    from rald_tpu.ops.attn_kernel import fused_self_attention_block as j_attn

    x, s, b, wq, wk, wv, wo, bo = (jnp.asarray(a, dtype) for a in args)
    return np.asarray(j_attn(x, s, b, wq.T, wk.T, wv.T, wo.T, bo, heads=heads,
                             scale_shift_mod=adaln, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("n", [32, 24])
def test_plain_matches_pallas(dtype, adaln, n):
    args = _inputs(2, n, 64, adaln, seed=n + adaln)
    want = _pallas(args, 4, adaln, getattr(jnp, dtype))
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    got = ta.fused_self_attention_block_plain(*t, heads=4, scale_shift_mod=adaln)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, 64)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 5e-3 * np.abs(want).max(), err
    # the bar catches a dropped out-projection bias
    t[7] = torch.zeros_like(t[7])
    moved = np.abs(ta.fused_self_attention_block_plain(*t, heads=4, scale_shift_mod=adaln)
                   .float().numpy() - want).max()
    assert moved > 5e-3 * np.abs(want).max()


def test_heads_round_per_head_in_bf16():
    """The bf16 kernel rounds each head's a @ v before the out-projection
    (the int8 kernels keep it f32): the plain version must too."""
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(1, 16, 64, True, seed=3)]
    x, s, b, wq, wk, wv, wo, bo = args
    xf, h = ta.ln_mod_f32(x, s, b, True, 1e-5)
    hb = h.to(x.dtype).float()
    q, k, v = (torch.matmul(hb, w.float().t()).to(x.dtype) for w in (wq, wk, wv))
    o_f32 = ta._attend(q, k, v, 4)
    o_bf16 = ta._attend(q, k, v, 4, round_heads=True)
    assert torch.equal(o_bf16, o_f32.bfloat16().float()) and not torch.equal(o_bf16, o_f32)
    want = (torch.matmul(o_bf16, wo.float().t()) + bo.float() + xf).bfloat16()
    torch.testing.assert_close(ta.fused_self_attention_block_plain(*args, heads=4), want,
                               rtol=0, atol=0)


def test_cpu_tensors_take_plain_path_without_counting():
    from rald_torch.ops import reset_launch_counts

    t = [torch.from_numpy(a) for a in _inputs(2, 24, 64, True, seed=5)]
    reset_launch_counts()
    got = ta.fused_self_attention_block(*t, heads=4)
    assert ta.fused_self_attention_block.launches == 0
    torch.testing.assert_close(got, ta.fused_self_attention_block_plain(*t, heads=4),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_operands():
    x, s, b, wq, wk, wv, wo, bo = (torch.from_numpy(a) for a in _inputs(2, 8, 64, True, seed=6))
    with pytest.raises(ValueError, match="broadcastable"):  # per-token mod rows
        ta.fused_self_attention_block(x, s.expand(2, 8, 64), b, wq, wk, wv, wo, bo, heads=4)
    with pytest.raises(ValueError, match="wv has shape"):
        ta.fused_self_attention_block(x, s, b, wq, wk, wv[:32], wo, bo, heads=4)
    with pytest.raises(ValueError, match="bo has"):
        ta.fused_self_attention_block(x, s, b, wq, wk, wv, wo, bo[:8], heads=4)
    with pytest.raises(ValueError, match="multiple of heads"):
        ta.fused_self_attention_block(x, s, b, wq, wk, wv, wo, bo, heads=5)


def test_per_frame_rows_move_output_past_the_card_bar():
    """With one AdaLN row per frame, giving every frame frame 0's row moves
    the output past the card's 2e-2 * max|out| bar (so the card test catches
    a kernel that reads the wrong frame's row), and the CPU dispatch applies
    each frame its own row."""
    t = [torch.from_numpy(a) for a in _inputs(3, 20, 64, True, seed=8)]
    want = ta.fused_self_attention_block(*t, heads=4)
    for i in range(3):
        one = ta.fused_self_attention_block_plain(t[0][i:i + 1], t[1][i:i + 1], t[2][i:i + 1],
                                                  *t[3:], heads=4)
        torch.testing.assert_close(want[i:i + 1], one, rtol=0, atol=1e-6)
    row0 = [a[:1].expand_as(a) for a in t[1:3]]
    frame0 = ta.fused_self_attention_block_plain(t[0], *row0, *t[3:], heads=4)
    assert (frame0 - want).abs().max() > 2e-2 * want.abs().max()


@pytest.mark.parametrize("bsz,n,heads,sms,rows", [
    (1, 512, 8, 132, 32),    # batch 1: 64-row blocks would give 64 blocks for 132 SMs
    (8, 512, 8, 132, 128),   # batch 8: 256 blocks of 128 rows
    (4, 512, 8, 132, 64),    # 128 blocks of 128 rows would leave 4 SMs idle
    (3, 300, 8, 132, 32),    # ragged: 5 x 8 x 3 = 120 blocks of 64 rows
    (1, 832, 8, 132, 32),
    (1, 512, 8, 64, 64),     # a smaller card fills with a larger block
])
def test_core_rows_fill_the_card(bsz, n, heads, sms, rows):
    assert ta.core_rows(bsz, n, heads, sms) == rows
    for big in ta.CORE_ROWS[:ta.CORE_ROWS.index(rows)]:  # every larger block leaves SMs idle
        assert -(-n // big) * heads * bsz < sms


def test_launch_tiles_follow_the_rules():
    """The core's warps and both GEMM tiles, each chosen to fill the card:
    the q / k / v launch counts its three weights' columns."""
    from rald_torch.ops.geglu_kernel import gemm2_tile

    assert ta.launch_tiles(1, 512, 512, 8, 3, 132) == (2, (64, 64), (64, 64))
    assert ta.launch_tiles(8, 512, 512, 8, 3, 132) == (8, (128, 128), (128, 64))
    for bsz, n, nproj in ((1, 512, 2), (3, 300, 3), (8, 512, 2)):
        warps, proj, out = ta.launch_tiles(bsz, n, 512, 8, nproj, 132)
        assert warps == ta.core_rows(bsz, n, 8, 132) // 16
        assert proj == gemm2_tile(bsz * n, nproj * 512, 132)
        assert out == gemm2_tile(bsz * n, 512, 132)


def _case(adaln, bsz, n, per_batch=False):
    return pytest.param(adaln, bsz, n, per_batch,
                        id=f"{adaln}-{bsz}-{n}" + ("-per_frame_rows" if per_batch else ""))


@pytest.mark.gpu
@pytest.mark.parametrize("adaln,bsz,n,per_batch", [
    _case(True, 1, 512), _case(True, 8, 512), _case(True, 3, 300),
    _case(False, 1, 512), _case(False, 8, 512), _case(False, 3, 300),
    # one AdaLN row per frame, as the DiT passes them; at (3, 300) the
    # core's query tiles and the GEMMs' row tiles straddle frames
    _case(True, 8, 512, True), _case(True, 3, 300, True)])
def test_cuda_kernel_matches_plain(cuda, bsz, n, adaln, per_batch):
    args = [torch.from_numpy(a).to(cuda).bfloat16()
            for a in _inputs(bsz, n, 512, adaln, seed=bsz * n + per_batch)]
    if adaln and not per_batch:  # one row shared by the batch, as the sampler's mod table gives
        args[1], args[2] = args[1][:1], args[2][:1]
    before = ta.fused_self_attention_block.launches
    got = ta.fused_self_attention_block(*args, scale_shift_mod=adaln)
    want = ta.fused_self_attention_block_plain(*args, scale_shift_mod=adaln)
    torch.cuda.synchronize()
    assert ta.fused_self_attention_block.launches == before + 1
    bar = 2e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bar
    if per_batch:  # the bar catches a kernel that gives every frame frame 0's row
        row0 = [a[:1].expand_as(a) for a in args[1:3]]
        frame0 = ta.fused_self_attention_block_plain(args[0], *row0, *args[3:])
        assert (frame0.float() - want.float()).abs().max().item() > bar


@pytest.mark.gpu
@pytest.mark.parametrize("adaln,bsz,n,per_batch", [
    _case(True, 1, 512), _case(True, 8, 512), _case(True, 3, 300), _case(False, 1, 512),
    _case(True, 8, 512, True), _case(True, 3, 300, True)])
def test_cuda_kernel_f32_matches_plain(cuda, bsz, n, adaln, per_batch):
    """float32 x: the f32 projections and core compute exact f32 products,
    so only the order of the f32 sums (and expf's last bits) differ from the
    plain version: 1e-4 of max|out|."""
    torch.set_float32_matmul_precision("highest")
    args = [torch.from_numpy(a).to(cuda)
            for a in _inputs(bsz, n, 512, adaln, seed=bsz * n + per_batch + 1)]
    if adaln and not per_batch:
        args[1], args[2] = args[1][:1], args[2][:1]
    before = ta.fused_self_attention_block.launches
    got = ta.fused_self_attention_block(*args, scale_shift_mod=adaln)
    want = ta.fused_self_attention_block_plain(*args, scale_shift_mod=adaln)
    torch.cuda.synchronize()
    assert ta.fused_self_attention_block.launches == before + 1 and got.dtype == torch.float32
    bar = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bar
    dropped = list(args)
    dropped[7] = torch.zeros_like(dropped[7])  # the bar catches a dropped out bias
    assert (ta.fused_self_attention_block_plain(*dropped, scale_shift_mod=adaln)
            - want).abs().max().item() > bar
    if per_batch:
        row0 = [a[:1].expand_as(a) for a in args[1:3]]
        frame0 = ta.fused_self_attention_block_plain(args[0], *row0, *args[3:])
        assert (frame0 - want).abs().max().item() > bar


@pytest.mark.gpu
def test_cuda_kernel_rejects_float16(cuda):
    args = [torch.from_numpy(a).to(cuda, torch.float16) for a in _inputs(1, 64, 512, True, seed=0)]
    with pytest.raises(TypeError, match="bf16 or float32"):
        ta.fused_self_attention_block(*args)
