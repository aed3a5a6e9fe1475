"""``fused_ln_geglu_residual``: the port's plain version against rald_tpu's
Pallas kernel (interpret mode) on the CPU, the CPU dispatch, the wrapper's
checks, and -- on the card only -- the CUDA kernel against its plain
version.

On the CPU both sides run float32: the plain version mirrors the kernel's
rounding points, so they differ only in summation order (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.ops import geglu_kernel as tg
from rald_tpu.ops.geglu_kernel import fused_ln_geglu_residual as j_fused

TOL = dict(atol=1e-5, rtol=1e-5)


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


def _inputs(bsz, n, dim, inner, adaln, seed=0, row_per_batch=False):
    """JAX-layout numpy operands: w1 (D, 2*inner), w2 (inner, D)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    x = f(bsz, n, dim, std=2.0) + 0.3
    rows = bsz if row_per_batch else 1
    if adaln:
        s, b = f(rows, 1, dim, std=0.3), f(rows, 1, dim, std=0.3)
    else:
        s, b = 1.0 + f(rows, 1, dim, std=0.2), f(rows, 1, dim, std=0.2)
    w1, b1 = f(dim, 2 * inner, std=dim ** -0.5), f(2 * inner, std=0.1)
    w2, b2 = f(inner, dim, std=inner ** -0.5), f(dim, std=0.1)
    return x, s, b, w1, b1, w2, b2


def _torch_args(x, s, b, w1, b1, w2, b2):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return t(x), t(s), t(b), t(w1.T), t(b1), t(w2.T), t(b2)


def _jax(x, s, b, w1, b1, w2, b2, adaln, block):
    out = j_fused(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w1),
                  jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
                  scale_shift_mod=adaln, block=block, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("n", [64, 50])  # 50: ragged against the 16-row block
def test_plain_matches_pallas_tiny(adaln, n):
    ops = _inputs(2, n, 32, 64, adaln, seed=n, row_per_batch=True)
    want = _jax(*ops, adaln, block=16)
    got = tg.fused_ln_geglu_residual_plain(*_torch_args(*ops), scale_shift_mod=adaln)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("adaln", [True, False])
def test_plain_matches_pallas_full_width(adaln):
    """D = 512, inner 2048, 512 tokens, batch 1: the product sublayer."""
    ops = _inputs(1, 512, 512, 2048, adaln, seed=7)
    want = _jax(*ops, adaln, block=256)
    got = tg.fused_ln_geglu_residual_plain(*_torch_args(*ops), scale_shift_mod=adaln)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cpu_tensor_takes_plain_path_without_counting():
    from rald_torch.ops import reset_launch_counts

    ops = _torch_args(*_inputs(2, 40, 32, 64, True, seed=3))
    reset_launch_counts()
    got = tg.fused_ln_geglu_residual(*ops, scale_shift_mod=True)
    assert tg.fused_ln_geglu_residual.launches == 0
    torch.testing.assert_close(got, tg.fused_ln_geglu_residual_plain(*ops), rtol=0, atol=0)


def test_bf16_rounding_points_match_pallas():
    """In bf16 the plain version rounds where the Pallas kernel rounds."""
    x, s, b, w1, b1, w2, b2 = _inputs(1, 64, 64, 128, True, seed=11)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    ops = tuple(bf(a) for a in (x, s, b, w1, b1, w2, b2))
    want = np.asarray(j_fused(*(jnp.asarray(a, jnp.bfloat16) for a in ops), block=64,
                              interpret=True).astype(jnp.float32))
    got = tg.fused_ln_geglu_residual_plain(*(a.to(torch.bfloat16) for a in _torch_args(*ops)))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at the output's magnitude: the f32 sums differ in order
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8 * np.abs(want).max(), rtol=0)


def test_per_frame_rows_move_output_past_the_card_bar():
    """With one modulation row per frame, giving every frame frame 0's row
    moves the output past the card's 2e-2 * max|out| bar (so the card test
    catches a kernel that indexes the rows wrongly), and the CPU dispatch
    applies each frame its own row."""
    x, s, b, w1, b1, w2, b2 = _torch_args(*_inputs(3, 20, 32, 64, True, seed=5,
                                                   row_per_batch=True))
    want = tg.fused_ln_geglu_residual(x, s, b, w1, b1, w2, b2)
    for i in range(3):
        one = tg.fused_ln_geglu_residual_plain(x[i:i + 1], s[i:i + 1], b[i:i + 1], w1, b1, w2, b2)
        torch.testing.assert_close(want[i:i + 1], one, rtol=0, atol=1e-6)
    frame0 = tg.fused_ln_geglu_residual_plain(x, s[:1].expand_as(s), b[:1].expand_as(b),
                                              w1, b1, w2, b2)
    assert (frame0 - want).abs().max() > 2e-2 * want.abs().max()


@pytest.mark.parametrize("rows,cols,sms,tile", [
    (512, 512, 132, (64, 64)),      # batch 1: 64 blocks, the most the tiles give
    (4096, 512, 132, (128, 64)),    # batch 8: 128 x 128 would leave 4 SMs idle
    (8192, 512, 132, (128, 128)),
    (4096, 768, 132, (128, 128)),   # geglu_ff's out_dim 768
    (154, 512, 132, (64, 64)),      # (2, 77): ragged
    (4096, 512, 64, (128, 128)),    # a smaller card fills with the largest tile
])
def test_gemm2_tile_fills_the_card(rows, cols, sms, tile):
    assert tg.gemm2_tile(rows, cols, sms) == tile
    bm, bn = tile
    assert tile in tg.GEMM2_TILES
    # every larger tile leaves SMs without a block
    for big in tg.GEMM2_TILES[:tg.GEMM2_TILES.index(tile)]:
        assert -(-rows // big[0]) * -(-cols // big[1]) < sms


def test_tma_alignment_check():
    """TMA needs 16-byte-aligned operands: the wrapper's check raises on an
    offset view before anything launches."""
    ok = torch.zeros(64, dtype=torch.bfloat16)
    tg._check_tma("fused_ln_geglu_residual", (ok, ok))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tg._check_tma("fused_ln_geglu_residual", (ok, ok[1:]))


@pytest.mark.parametrize("dtype,f32", [(torch.bfloat16, 0), (torch.float32, 1),
                                       (torch.float16, None), (torch.float64, None)])
def test_check_act_dtype_picks_the_instantiation(dtype, f32):
    """The dtype gate of every FF and attention wrapper on the card: bf16
    and float32 x pick their instantiation, any other dtype raises."""
    x = torch.zeros(2, 4, dtype=dtype)
    if f32 is None:
        with pytest.raises(TypeError, match="bf16 or float32"):
            tg.check_act_dtype("k", x)
    else:
        assert tg.check_act_dtype("k", x) == f32


def test_wrapper_rejects_bad_modulation_rows():
    x, s, b, w1, b1, w2, b2 = _torch_args(*_inputs(2, 8, 32, 64, True))
    per_token = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="broadcastable"):
        tg.fused_ln_geglu_residual(x, per_token, b, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="do not match"):
        tg.fused_ln_geglu_residual(x, s, b, w1[:, :16], b1, w2, b2)


def _case(bsz, n, adaln, per_batch=False):
    return pytest.param(bsz, n, adaln, per_batch,
                        id=f"{bsz}-{n}-{adaln}" + ("-per_batch_rows" if per_batch else ""))


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,adaln,per_batch", [
    _case(1, 512, True), _case(8, 512, True), _case(1, 512, False), _case(8, 512, False),
    _case(3, 300, True), _case(2, 77, False),
    # one AdaLN row per frame, as the DiT passes them; at (3, 300) the
    # kernel's 128-row tiles straddle frames
    _case(8, 512, True, True), _case(3, 300, True, True)])
def test_cuda_kernel_matches_plain(cuda, bsz, n, adaln, per_batch):
    """Main-path shapes in bf16; bf16 keeps ~3 significant digits over the
    512/2048-term sums, so the bar is 2e-2 of max|out|."""
    ops = tuple(t.to(cuda, torch.bfloat16).contiguous()
                for t in _torch_args(*_inputs(bsz, n, 512, 2048, adaln, seed=bsz + n,
                                              row_per_batch=per_batch)))
    if not per_batch:
        ops = (ops[0], ops[1].reshape(1, 512), ops[2].reshape(1, 512)) + ops[3:]
    before = tg.fused_ln_geglu_residual.launches
    got = tg.fused_ln_geglu_residual(*ops, scale_shift_mod=adaln)
    want = tg.fused_ln_geglu_residual_plain(*ops, scale_shift_mod=adaln)
    torch.cuda.synchronize()
    assert tg.fused_ln_geglu_residual.launches == before + 1
    bar = 2e-2 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= bar
    if per_batch:  # the bar catches a kernel that gives every frame frame 0's row
        row0 = tuple(t[:1].expand_as(t) for t in ops[1:3])
        frame0 = tg.fused_ln_geglu_residual_plain(ops[0], *row0, *ops[3:], scale_shift_mod=adaln)
        assert (frame0.float() - want.float()).abs().max().item() > bar


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,adaln,per_batch", [
    _case(1, 512, True), _case(8, 512, True), _case(1, 512, False), _case(3, 300, True),
    _case(2, 77, False), _case(8, 512, True, True), _case(3, 300, True, True)])
def test_cuda_kernel_f32_matches_plain(cuda, bsz, n, adaln, per_batch):
    """x in float32 (JAX's compute_dtype float32): the f32 kernel computes
    exact f32 products, so it differs from its plain version only in the
    order of its f32 sums and in the TPU kernel's A&S erf (1.5e-7): the bar
    is 1e-4 of max|out|."""
    torch.set_float32_matmul_precision("highest")
    ops = tuple(t.to(cuda).contiguous()
                for t in _torch_args(*_inputs(bsz, n, 512, 2048, adaln, seed=bsz + n + 1,
                                              row_per_batch=per_batch)))
    if not per_batch:
        ops = (ops[0], ops[1].reshape(1, 512), ops[2].reshape(1, 512)) + ops[3:]
    before = tg.fused_ln_geglu_residual.launches
    got = tg.fused_ln_geglu_residual(*ops, scale_shift_mod=adaln)
    want = tg.fused_ln_geglu_residual_plain(*ops, scale_shift_mod=adaln)
    torch.cuda.synchronize()
    assert tg.fused_ln_geglu_residual.launches == before + 1 and got.dtype == torch.float32
    bar = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bar
    for i in (4, 6):  # the bar catches a dropped bias
        dropped = list(ops)
        dropped[i] = torch.zeros_like(dropped[i])
        moved = tg.fused_ln_geglu_residual_plain(*dropped, scale_shift_mod=adaln)
        assert (moved - want).abs().max().item() > bar
    if per_batch:
        row0 = tuple(t[:1].expand_as(t) for t in ops[1:3])
        frame0 = tg.fused_ln_geglu_residual_plain(ops[0], *row0, *ops[3:], scale_shift_mod=adaln)
        assert (frame0 - want).abs().max().item() > bar


@pytest.mark.gpu
def test_cuda_kernel_rejects_float16(cuda):
    ops = tuple(t.to(cuda, torch.float16) for t in _torch_args(*_inputs(1, 16, 512, 2048, True)))
    with pytest.raises(TypeError, match="bf16 or float32"):
        tg.fused_ln_geglu_residual(*ops)
