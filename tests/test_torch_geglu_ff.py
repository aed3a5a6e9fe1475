"""``geglu_ff`` (the GEGLU FF without LN and residual): the port's plain
version against rald_tpu's Pallas kernel (interpret mode) in float32 and
bfloat16, with leading axes, a ragged token count and an ``out_dim`` other
than ``dim``; ``GEGLUFeedForward(use_fused=True)`` against JAX's module with
the same flag; the wrapper's CPU dispatch and checks; and -- on the card
only -- the CUDA kernel against its plain version.

Bar 5e-3 * max|out| against Pallas (f32 summation order, and the bf16
roundings that follow from it); 2e-2 * max|out| for the bf16 CUDA kernel,
whose 512- and 2048-term sums run in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.ops import geglu_kernel as tg


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


def _inputs(shape, inner, out_dim, seed):
    """x, w1 (2*inner, D), b1, w2 (out_dim, inner), b2 (torch layout), numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, std=1.0: (rng.normal(size=sh) * std).astype(np.float32)
    d = shape[-1]
    return [f(*shape), f(2 * inner, d, std=d ** -0.5), f(2 * inner, std=0.5),
            f(out_dim, inner, std=inner ** -0.5), f(out_dim, std=0.5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out_dim", [((2, 24, 64), 64), ((37, 64), 48)])
def test_plain_matches_pallas(dtype, shape, out_dim):
    from rald_tpu.ops.geglu_kernel import geglu_ff as j_ff

    args = _inputs(shape, 128, out_dim, seed=len(shape) + out_dim)
    x, w1, b1, w2, b2 = (jnp.asarray(a, getattr(jnp, dtype)) for a in args)
    want = np.asarray(j_ff(x, w1.T, b1, w2.T, b2, block=16, interpret=True).astype(jnp.float32))
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    got = tg.geglu_ff_plain(*t)
    assert got.shape == (*shape[:-1], out_dim) and got.dtype == t[0].dtype
    bar = 5e-3 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= bar
    for i in (2, 4):  # the bar catches a dropped bias
        t2 = list(t)
        t2[i] = torch.zeros_like(t2[i])
        assert np.abs(tg.geglu_ff_plain(*t2).float().numpy() - want).max() > bar


def _modules(dim, seed):
    from rald_torch.nn.layers import GEGLUFeedForward as TFF
    from rald_tpu.nn.layers import GEGLUFeedForward as JFF

    x = np.random.default_rng(seed).normal(size=(2, 24, dim)).astype(np.float32)
    jff = JFF()
    params = jax.tree_util.tree_map(np.array, jff.init(jax.random.PRNGKey(seed), x)["params"])
    tff = TFF(dim)
    with torch.no_grad():
        for lin, name in ((tff.proj_in, "proj_in"), (tff.proj_out, "proj_out")):
            lin.weight.copy_(torch.from_numpy(params[name]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(params[name]["bias"]) + 0.1)
            params[name]["bias"] = params[name]["bias"] + 0.1  # non-zero biases
    return x, jff, params, tff


def test_module_use_fused_matches_jax():
    from jax.experimental.pallas import tpu as pltpu

    x, jff, params, tff = _modules(64, seed=7)
    # jitted: eager dispatch beside the interpreter's io_callbacks can deadlock
    fused = jax.jit(lambda p, a: jff.copy(use_fused=True).apply({"params": p}, a))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused(params, jnp.asarray(x)))
    tff.use_fused = True
    with torch.no_grad():
        got = tff(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * np.abs(want).max())
    # and the unfused module, JAX's and the port's, agrees with both
    unfused = np.asarray(jff.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, unfused, rtol=0, atol=5e-3 * np.abs(want).max())


def test_module_amax_stays_unfused():
    """``amax=`` (calibration) runs the unfused FF, as JAX's ``sow_amax``."""
    from rald_torch.ops import reset_launch_counts

    x, _, _, tff = _modules(64, seed=8)
    tff.use_fused = True
    reset_launch_counts()
    stats = []
    with torch.no_grad():
        got = tff(torch.from_numpy(x), amax=stats)
        tff.use_fused = False
        want = tff(torch.from_numpy(x))
    assert len(stats) == 1 and float(stats[0][0]) == float(np.abs(x).max())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tg.geglu_ff.launches == 0


def test_cpu_dispatch_and_checks():
    from rald_torch.ops import reset_launch_counts

    t = [torch.from_numpy(a) for a in _inputs((3, 5, 32), 64, 16, seed=9)]
    reset_launch_counts()
    torch.testing.assert_close(tg.geglu_ff(*t), tg.geglu_ff_plain(*t), rtol=0, atol=0)
    assert tg.geglu_ff.launches == 0
    with pytest.raises(ValueError, match="do not match"):
        tg.geglu_ff(t[0], t[1][:, :16], *t[2:])
    with pytest.raises(ValueError, match="do not match"):
        tg.geglu_ff(t[0], t[1], t[2], t[3], t[4][:3])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_dim", [((1, 512, 512), 512), ((8, 512, 512), 512),
                                           ((1000, 512), 512), ((2, 256, 512), 768)])
def test_cuda_kernel_matches_plain(cuda, shape, out_dim):
    args = [torch.from_numpy(a).to(cuda).bfloat16()
            for a in _inputs(shape, 2048, out_dim, seed=out_dim + len(shape))]
    before = tg.geglu_ff.launches
    got = tg.geglu_ff(*args)
    want = tg.geglu_ff_plain(*args)
    torch.cuda.synchronize()
    assert tg.geglu_ff.launches == before + 1 and got.shape == want.shape
    ref = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * ref


@pytest.mark.gpu
@pytest.mark.parametrize("shape,out_dim", [((1, 512, 512), 512), ((8, 512, 512), 512),
                                           ((1000, 512), 512), ((2, 256, 512), 768)])
def test_cuda_kernel_f32_matches_plain(cuda, shape, out_dim):
    """float32 x: exact f32 products, so only the sums' order and the A&S
    erf (1.5e-7) differ from the plain version: 1e-4 of max|out|."""
    torch.set_float32_matmul_precision("highest")
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, 2048, out_dim, seed=out_dim + 3)]
    before = tg.geglu_ff.launches
    got = tg.geglu_ff(*args)
    want = tg.geglu_ff_plain(*args)
    torch.cuda.synchronize()
    assert tg.geglu_ff.launches == before + 1 and got.dtype == torch.float32
    bar = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bar
    for i in (2, 4):  # the bar catches a dropped bias
        dropped = list(args)
        dropped[i] = torch.zeros_like(dropped[i])
        assert (tg.geglu_ff_plain(*dropped) - want).abs().max().item() > bar
