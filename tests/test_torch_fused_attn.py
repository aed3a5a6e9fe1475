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


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n", [(1, 512), (8, 512), (3, 300)])
@pytest.mark.parametrize("adaln", [True, False])
def test_cuda_kernel_matches_plain(cuda, bsz, n, adaln):
    args = [torch.from_numpy(a).to(cuda).bfloat16()
            for a in _inputs(bsz, n, 512, adaln, seed=bsz * n)]
    if adaln:  # one row shared by the batch, as the sampler's mod table gives
        args[1], args[2] = args[1][:1], args[2][:1]
    before = ta.fused_self_attention_block.launches
    got = ta.fused_self_attention_block(*args, scale_shift_mod=adaln)
    want = ta.fused_self_attention_block_plain(*args, scale_shift_mod=adaln)
    torch.cuda.synchronize()
    assert ta.fused_self_attention_block.launches == before + 1
    ref = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * ref
