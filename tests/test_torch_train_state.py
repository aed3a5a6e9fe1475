"""The port's LR schedule and train state against ``rald_tpu``'s on identical
numpy gradients (no model):

- ``warmup_cosine_schedule`` at warmup, the warmup boundary and the end,
  within 1e-6 * lr (JAX computes in float32: near the end, 1 + cos loses
  digits);
- ``TrainState.apply_gradients`` against ``create_train_state``'s optax
  chain over 5 steps: clip active and inactive, ``skip_nonfinite`` with a
  NaN step, ``accum_iter: 2``, the EMA, the Adam moments and the counters.
  Parameters and EMA after k steps within k * 1e-6 (the gradients are the
  same numbers on both sides, so no gradient sits at rounding level and
  the 2 * lr * k allowance of the model tests is not needed), the moments
  within 1e-6 relative;
- ``torch.optim.AdamW`` with its lr set per update computes optax's
  ``adamw`` arithmetic: one parameter, 5 steps, within 1e-6 relative plus
  1e-5 of the summed lr (optax computes ``1 - 0.999^count`` in float32,
  1.3e-5 off at count 1, so each of its updates is off by up to 7e-6 of
  its size; torch takes those factors in double)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rald_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from rald_tpu.train.state import create_train_state
from rald_torch.train.schedule import scale_base_lr, warmup_cosine_schedule
from rald_torch.train.state import TrainState

SHAPES = {"a.weight": (6, 5), "a.bias": (6,), "b.weight": (3, 4, 2)}


@pytest.mark.parametrize("warmup", [0, 2.0, 0.5])
def test_schedule_matches_jax(warmup):
    lr, min_lr, epochs, spe = 3e-4, 1e-6, 10, 7
    want = jax_schedule(lr, min_lr, warmup, epochs, spe)
    got = warmup_cosine_schedule(lr, min_lr, warmup, epochs, spe)
    steps = [0, 1, 3, int(warmup * spe) - 1, int(warmup * spe), int(warmup * spe) + 1,
             epochs * spe // 2, epochs * spe - 1, epochs * spe]
    for s in steps:
        if s < 0:
            continue
        w = float(want(jnp.asarray(s, jnp.int32)))
        assert got(s) == pytest.approx(w, rel=0, abs=1e-6 * lr), s
    assert scale_base_lr(1e-4, 8, 2, 1) == 1e-4 * 16 / 256


def _draws(steps: int, nan_step=None, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(steps):
        g = {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}
        if i == nan_step:
            g["a.bias"][2] = np.nan
        grads.append(g)
    return params, grads


def _run_both(clip, skip_nonfinite=False, accum_iter=1, nan_step=None, steps=5):
    lr = warmup_cosine_schedule(1e-2, 1e-4, 1.0, 3, 2)
    params, grads = _draws(steps, nan_step)
    jstate = create_train_state({k: jnp.asarray(v) for k, v in params.items()},
                                jax_schedule(1e-2, 1e-4, 1.0, 3, 2), clip_grad=clip,
                                skip_nonfinite=skip_nonfinite, accum_iter=accum_iter)
    tstate = TrainState({k: torch.from_numpy(v.copy()) for k, v in params.items()}, lr,
                        clip_grad=clip, skip_nonfinite=skip_nonfinite, accum_iter=accum_iter)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    out = []
    for k, g in enumerate(grads):
        jstate = apply(jstate, {n: jnp.asarray(v) for n, v in g.items()})
        moved = tstate.apply_gradients({n: torch.from_numpy(v.copy()) for n, v in g.items()})
        out.append((jax.device_get(jstate), moved))
        _compare(jstate, tstate, k + 1)
    return jstate, tstate, out


def _leaf(tree, name):
    return np.asarray(tree[name])


def _compare(jstate, tstate, k):
    bar = k * 1e-6
    assert tstate.step == int(jstate.step)
    for name in SHAPES:
        for want, got in ((jstate.params, tstate.params), (jstate.ema_params, tstate.ema_params)):
            np.testing.assert_allclose(got[name].numpy(), _leaf(want, name), rtol=0, atol=bar)


def _adam_state(opt_state):
    """(ScaleByAdamState, the wrappers' states) of an optax chain state."""
    found = {}

    def walk(s):
        if hasattr(s, "_fields"):
            if "mu" in s._fields:
                found["adam"] = s
                return
            for f in s._fields:
                found.setdefault(f, getattr(s, f))
                walk(getattr(s, f))
        elif isinstance(s, tuple):
            for v in s:
                walk(v)

    walk(opt_state)
    return found


@pytest.mark.parametrize("clip", [None, 1.0, 100.0], ids=["no_clip", "clip_active", "clip_inactive"])
def test_optimizer_matches_optax(clip):
    jstate, tstate, _ = _run_both(clip)
    adam = _adam_state(jstate.opt_state)["adam"]
    opt = tstate.opt_state()
    assert opt["count"] == int(adam.count) == 5
    for name in SHAPES:
        np.testing.assert_allclose(opt["mu"][name].numpy(), _leaf(adam.mu, name), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt["nu"][name].numpy(), _leaf(adam.nu, name), rtol=1e-6, atol=1e-9)
    if clip == 1.0:  # every draw's norm is above 1: the clip acted
        assert all(np.sqrt(sum((v ** 2).sum() for v in g.values())) > 1 for g in _draws(5)[1])


def test_skip_nonfinite_nan_step():
    jstate, tstate, out = _run_both(1.0, skip_nonfinite=True, nan_step=2)
    assert [moved for _, moved in out] == [True, True, False, True, True]
    # the skipped step left params and moments alone, but step and EMA moved
    before, skipped = out[1][0], out[2][0]
    for name in SHAPES:
        np.testing.assert_array_equal(_leaf(skipped.params, name), _leaf(before.params, name))
        assert not np.array_equal(_leaf(skipped.ema_params, name), _leaf(before.ema_params, name))
    assert int(skipped.step) == 3
    found = _adam_state(jstate.opt_state)
    assert tstate.opt_state()["count"] == int(found["adam"].count) == 4
    assert tstate.total_notfinite == int(found["total_notfinite"]) == 1
    assert tstate.notfinite_count == int(found["notfinite_count"]) == 0


def test_accum_iter_two():
    jstate, tstate, out = _run_both(1.0, accum_iter=2)
    # params move on every second call; the EMA on every call
    assert [moved for _, moved in out] == [False, True, False, True, False]
    for name in SHAPES:
        np.testing.assert_array_equal(_leaf(out[0][0].params, name), _draws(1)[0][name])
    found = _adam_state(jstate.opt_state)
    opt = tstate.opt_state()
    assert opt["count"] == int(found["adam"].count) == 2  # the schedule runs k times slower
    assert opt["mini_step"] == int(found["mini_step"]) == 1
    np.testing.assert_allclose(opt["acc_grads"]["b.weight"].numpy(),
                               _leaf(found["acc_grads"], "b.weight"), rtol=1e-6, atol=1e-7)


def test_torch_adamw_is_optax_adamw():
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(50).astype(np.float32)
    tx = optax.adamw(lambda c: 1e-2 / (1.0 + c), b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    opt = torch.optim.AdamW([tp], lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    lr_sum = 0.0
    for c in range(5):
        g = rng.standard_normal(50).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = 1e-2 / (1.0 + c)
        opt.step()
        lr_sum += 1e-2 / (1.0 + c)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-5 * lr_sum)
