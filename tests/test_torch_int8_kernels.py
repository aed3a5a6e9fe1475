"""The four int8 kernels of quantized inference: each plain version against
rald_tpu's Pallas kernel (interpret mode) on the CPU, the CPU dispatch, the
wrappers' checks, and -- on the card only -- each CUDA kernel against its
plain version.

Both sides quantize the same f32 weights (JAX's ``quantize_cols``, carried
over transposed) and share every rounding point, in float32 on the CPU. The
bar, max|d| <= 5e-3 * max|out|, leaves room for an int8 code that flips at
a .5 tie because the LN sums were reduced in another order; measured on
these inputs: 3.4e-8 to 2.9e-7 of max|out|, no flip (f32 summation noise)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.ops import attn_kernel as ta
from rald_torch.ops import geglu_kernel as tg

BAR = 5e-3


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= bar * np.abs(want).max(), (err, np.abs(want).max())


def _mods(rng, rows, dim, adaln):
    f = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    if adaln:
        return f(rows, 1, dim, std=0.3), f(rows, 1, dim, std=0.3)
    return 1.0 + f(rows, 1, dim, std=0.2), f(rows, 1, dim, std=0.2)


def _ff_operands(bsz, n, dim, inner, adaln, seed):
    """JAX-layout numpy operands with JAX-quantized weights, plus the same
    operands in the torch layout."""
    from rald_tpu.ops.geglu_kernel import quantize_cols

    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    x = f(bsz, n, dim, std=2.0) + 0.3
    s, b = _mods(rng, bsz, dim, adaln)
    w1, b1 = f(dim, 2 * inner, std=dim ** -0.5), f(2 * inner, std=0.1)
    w2, b2 = f(inner, dim, std=inner ** -0.5), f(dim, std=0.1)
    (w1q, s1), (w2q, s2) = quantize_cols(jnp.asarray(w1)), quantize_cols(jnp.asarray(w2))
    j = (x, s, b, np.asarray(w1q), np.asarray(s1), b1, np.asarray(w2q), np.asarray(s2), b2)
    t = (_t(x), _t(s), _t(b), _t(j[3].T), _t(j[4][0]), _t(b1), _t(j[6].T), _t(j[7][0]), _t(b2))
    return j, t


@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("n", [64, 50])  # 50: ragged against the 16-row block
def test_int8_ff_plain_matches_pallas(adaln, n):
    from rald_tpu.ops.geglu_kernel import fused_ln_geglu_residual_int8 as j_fn

    j, t = _ff_operands(2, n, 32, 64, adaln, seed=n)
    want = j_fn(*(jnp.asarray(a) for a in j), scale_shift_mod=adaln, block=16, interpret=True)
    got = tg.fused_ln_geglu_residual_int8_plain(*t, scale_shift_mod=adaln)
    _close(got.numpy(), want)


def _static_operands(j, t, ah, ag):
    """Fold the activation amax into the dequant rows as latent_dit does."""
    ah, ag = np.float32(ah), np.float32(ag)
    d1, d2 = j[4] * (ah / np.float32(127.0)), j[7] * (ag / np.float32(127.0))
    ih, ig = np.float32(127.0) / ah, np.float32(127.0) / ag
    jj = (*j[:4], d1, j[5], j[6], d2, j[8], np.reshape(ih, (1, 1)), np.reshape(ig, (1, 1)))
    tt = (*t[:4], _t(d1[0]), t[5], t[6], _t(d2[0]), t[8], _t(np.reshape(ih, (1,))),
          _t(np.reshape(ig, (1,))))
    return jj, tt


@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("calib", [1.0, 0.25])  # 0.25: amax 4x too small, saturating
def test_int8_ff_static_plain_matches_pallas(adaln, calib):
    from rald_tpu.ops.geglu_kernel import fused_ln_geglu_residual_int8_static as j_fn

    j, t = _ff_operands(2, 40, 32, 64, adaln, seed=5)
    jj, tt = _static_operands(j, t, 6.0 * calib, 3.0 * calib)
    want = j_fn(*(jnp.asarray(a) for a in jj), scale_shift_mod=adaln, block=16, interpret=True)
    got = tg.fused_ln_geglu_residual_int8_static_plain(*tt, scale_shift_mod=adaln)
    _close(got.numpy(), want)
    if calib < 1:  # saturated: the static output differs from the dynamic one
        dyn = tg.fused_ln_geglu_residual_int8_plain(*t, scale_shift_mod=adaln)
        assert (got - dyn).abs().max() > 0.05 * dyn.abs().max()


def _attn_operands(bsz, n, dim, adaln, seed):
    from rald_tpu.ops.attn_kernel import quantize_attn_tree

    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (rng.standard_normal(s) * std).astype(np.float32)
    x = f(bsz, n, dim, std=2.0) + 0.3
    s, b = _mods(rng, bsz, dim, adaln)
    ws = {k: f(dim, dim, std=dim ** -0.5) for k in ("to_q", "to_k", "to_v", "to_out")}
    bo = f(dim, std=0.1)
    qt = quantize_attn_tree({"attn1": {k: {"kernel": jnp.asarray(w)} for k, w in ws.items()}})
    qt = {k: np.asarray(v) for k, v in qt["attn1"].items()}
    return x, s, b, ws, qt, bo


def _attn_args(x, s, b, ws, qt, bo, vout: bool, layout: str):
    if layout == "jax":
        w = lambda k: qt[k]
        lead = (ws["to_q"], ws["to_k"]) if vout else (w("to_q_q"), w("to_q_s"), w("to_k_q"),
                                                       w("to_k_s"))
        return (x, s, b, *lead, w("to_v_q"), w("to_v_s"), w("to_out_q"), w("to_out_s"), bo)
    w = lambda k: _t(qt[k].T) if k.endswith("_q") else _t(qt[k][0])
    lead = (_t(ws["to_q"].T), _t(ws["to_k"].T)) if vout else (w("to_q_q"), w("to_q_s"),
                                                               w("to_k_q"), w("to_k_s"))
    return (_t(x), _t(s), _t(b), *lead, w("to_v_q"), w("to_v_s"), w("to_out_q"), w("to_out_s"),
            _t(bo))


@pytest.mark.parametrize("vout", [False, True])
@pytest.mark.parametrize("adaln", [True, False])
@pytest.mark.parametrize("n", [64, 37])
def test_int8_attn_plain_matches_pallas(vout, adaln, n):
    from rald_tpu.ops import attn_kernel as ja

    ops = _attn_operands(2, n, 32, adaln, seed=n + 10 * vout)
    j_fn = ja.fused_self_attention_block_int8_vout if vout else ja.fused_self_attention_block_int8
    t_fn = (ta.fused_self_attention_block_int8_vout_plain if vout
            else ta.fused_self_attention_block_int8_plain)
    want = j_fn(*(jnp.asarray(a) for a in _attn_args(*ops, vout, "jax")), heads=2,
                scale_shift_mod=adaln, interpret=True)
    got = t_fn(*_attn_args(*ops, vout, "torch"), heads=2, scale_shift_mod=adaln)
    _close(got.numpy(), want)


def test_bf16_rounding_points_match_pallas():
    """In bf16 (the product dtype) the plain versions round where the Pallas
    kernels round: one bf16 ulp at the output's magnitude."""
    from rald_tpu.ops import attn_kernel as ja
    from rald_tpu.ops.geglu_kernel import fused_ln_geglu_residual_int8 as j_ff

    j, t = _ff_operands(1, 64, 64, 128, True, seed=11)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = j_ff(bf(j[0]), bf(j[1]), bf(j[2]), *(jnp.asarray(a) for a in j[3:]), block=64,
                interpret=True).astype(jnp.float32)
    got = tg.fused_ln_geglu_residual_int8_plain(t[0].bfloat16(), t[1].bfloat16(),
                                                t[2].bfloat16(), *t[3:])
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, bar=2 ** -7)
    x, s, b, ws, qt, bo = _attn_operands(1, 64, 64, True, seed=12)
    ja_args = _attn_args(x, s, b, ws, qt, bo, True, "jax")
    want = ja.fused_self_attention_block_int8_vout(
        bf(x), bf(s), bf(b), *(jnp.asarray(a) for a in ja_args[3:]), heads=1,
        interpret=True).astype(jnp.float32)
    targs = _attn_args(x, s, b, ws, qt, bo, True, "torch")
    got = ta.fused_self_attention_block_int8_vout_plain(
        targs[0].bfloat16(), targs[1].bfloat16(), targs[2].bfloat16(), *targs[3:], heads=1)
    _close(got.float().numpy(), want, bar=2 ** -7)


def test_cpu_tensors_take_plain_path_without_counting():
    from rald_torch.ops import launch_counts, reset_launch_counts

    _, t = _ff_operands(2, 24, 32, 64, True, seed=3)
    ops = _attn_operands(2, 24, 32, True, seed=3)
    reset_launch_counts()
    pairs = [
        (tg.fused_ln_geglu_residual_int8(*t), tg.fused_ln_geglu_residual_int8_plain(*t)),
        (ta.fused_self_attention_block_int8(*_attn_args(*ops, False, "torch"), heads=2),
         ta.fused_self_attention_block_int8_plain(*_attn_args(*ops, False, "torch"), heads=2)),
        (ta.fused_self_attention_block_int8_vout(*_attn_args(*ops, True, "torch"), heads=2),
         ta.fused_self_attention_block_int8_vout_plain(*_attn_args(*ops, True, "torch"),
                                                      heads=2)),
    ]
    _, tt = _static_operands(*_ff_operands(2, 24, 32, 64, True, seed=3), 6.0, 3.0)
    pairs.append((tg.fused_ln_geglu_residual_int8_static(*tt),
                  tg.fused_ln_geglu_residual_int8_static_plain(*tt)))
    assert all(v == 0 for v in launch_counts().values())
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_reject_bad_operands():
    _, t = _ff_operands(2, 8, 32, 64, True, seed=0)
    with pytest.raises(ValueError, match="broadcastable"):
        tg.fused_ln_geglu_residual_int8(t[0], torch.zeros(2, 8, 32), *t[2:])
    with pytest.raises(ValueError, match="do not match"):
        tg.fused_ln_geglu_residual_int8(*t[:3], t[3][:, :16], *t[4:])
    with pytest.raises(ValueError, match="s1 has"):
        tg.fused_ln_geglu_residual_int8(*t[:4], t[4][:10], *t[5:])
    args = _attn_args(*_attn_operands(1, 8, 32, True, seed=0), False, "torch")
    with pytest.raises(ValueError, match="multiple of heads"):
        ta.fused_self_attention_block_int8(*args, heads=3)
    with pytest.raises(ValueError, match="wk_q has shape"):
        ta.fused_self_attention_block_int8(*args[:5], args[5][:, :8], *args[6:], heads=2)


# ----------------------------------------------------------------- on card
def _card_mods(bsz, n, adaln, rnd):
    """One AdaLN row shared by the batch, one per batch element for the
    ragged shape, or the affine LayerNorm's weight and bias."""
    if not adaln:
        return 1.0 + rnd(512, std=0.1), rnd(512, std=0.1)
    rows = (bsz, 1, 512) if n % 64 else (1, 512)
    return rnd(*rows, std=0.1), rnd(*rows, std=0.1)


def _card_ff(bsz, n, adaln, gen, dev):
    """Main-path-shaped FF operands on the card: D 512, inner 2048, bf16
    activations, int8 weights quantized from f32, f32 biases at std 0.5."""
    rnd = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std
    x = rnd(bsz, n, 512).bfloat16()
    s, b = _card_mods(bsz, n, adaln, rnd)
    w1q, s1 = tg.quantize_cols(rnd(4096, 512, std=512 ** -0.5))
    w2q, s2 = tg.quantize_cols(rnd(512, 2048, std=2048 ** -0.5))
    return x, s.bfloat16(), b.bfloat16(), w1q, s1, rnd(4096, std=0.5), w2q, s2, rnd(512, std=0.5)


def _card_attn(bsz, n, adaln, vout, gen, dev):
    rnd = lambda *s, std=1.0: torch.randn(s, generator=gen, device=dev) * std
    x = rnd(bsz, n, 512).bfloat16()
    s, b = _card_mods(bsz, n, adaln, rnd)
    w = [rnd(512, 512, std=512 ** -0.5) for _ in range(4)]
    qk = (w[0].bfloat16(), w[1].bfloat16()) if vout else (*tg.quantize_cols(w[0]),
                                                           *tg.quantize_cols(w[1]))
    return (x, s.bfloat16(), b.bfloat16(), *qk, *tg.quantize_cols(w[2]), *tg.quantize_cols(w[3]),
            rnd(512, std=0.5))


def _card_check(fn, plain, args, **kw):
    before = fn.launches
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


SHAPES = [(1, 512, True), (8, 512, True), (3, 300, True), (2, 77, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("bsz,n,adaln", SHAPES)
def test_cuda_int8_ff_matches_plain(cuda, bsz, n, adaln):
    """bf16 output over 512/2048-term sums of dequantized products: 2e-2 of
    max|out|, the bar of the bf16 kernel."""
    gen = torch.Generator(cuda).manual_seed(bsz * 1000 + n)
    args = _card_ff(bsz, n, adaln, gen, cuda)
    _card_check(tg.fused_ln_geglu_residual_int8, tg.fused_ln_geglu_residual_int8_plain, args,
                scale_shift_mod=adaln)
    x, s, b, w1q, s1, b1, w2q, s2, b2 = args
    ah = torch.full((1,), 4.0, device=cuda)
    ag = torch.full((1,), 2.0, device=cuda)
    static = (x, s, b, w1q, s1 * tg.div127(ah), b1, w2q, s2 * tg.div127(ag), b2, tg.inv127(ah),
              tg.inv127(ag))
    _card_check(tg.fused_ln_geglu_residual_int8_static, tg.fused_ln_geglu_residual_int8_static_plain,
                static, scale_shift_mod=adaln)


@pytest.mark.gpu
@pytest.mark.parametrize("vout", [False, True])
@pytest.mark.parametrize("bsz,n,adaln", SHAPES)
def test_cuda_int8_attn_matches_plain(cuda, bsz, n, adaln, vout):
    gen = torch.Generator(cuda).manual_seed(bsz * 1000 + n + vout)
    args = _card_attn(bsz, n, adaln, vout, gen, cuda)
    fn, plain = ((ta.fused_self_attention_block_int8_vout, ta.fused_self_attention_block_int8_vout_plain)
                 if vout else (ta.fused_self_attention_block_int8,
                               ta.fused_self_attention_block_int8_plain))
    _card_check(fn, plain, args, scale_shift_mod=adaln)


@pytest.mark.gpu
def test_cuda_int8_kernels_reject_f32(cuda):
    gen = torch.Generator(cuda).manual_seed(0)
    x, *rest = _card_ff(1, 16, True, gen, cuda)
    with pytest.raises(TypeError, match="bf16"):
        tg.fused_ln_geglu_residual_int8(x.float(), *rest)
    x, *rest = _card_attn(1, 16, True, False, gen, cuda)
    with pytest.raises(TypeError, match="bf16"):
        ta.fused_self_attention_block_int8(x.float(), *rest)
