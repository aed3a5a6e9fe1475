"""The port's training step against ``rald_tpu``'s ``GenerationEngine._train_step``
on the CPU, float32 with ``matmul_precision: highest``, at a tiny size (DiT
depth 2, 16 latents; the radar encoder at 8 channels on a (32, 32, 32) cube,
so that its deepest GroupNorms normalise 8 values: at (32, 16, 16) they
normalise 2, and the encoder's gradients are rounding noise on both sides).
Both sides start from one JAX train state (parameters drawn in
``model.init``'s tree, carried over by ``train_state_from_flax``) and take
the same latents, cubes and unit-normal draws (JAX's, rebuilt from its
keys as ``edm_loss`` splits them). Bars:

- ``edm_loss`` and a step's loss: 1e-5 relative; ``grad_norm`` 1e-4;
- gradients before any step: 1e-4 of each tensor's max |g|, the max taken
  at least 1e-2 of the largest: tensors whose exact gradient is zero (a
  conv bias in front of a one-channel GroupNorm, an attention key bias)
  hold rounding noise only;
- params and EMA after k steps: k * 1e-6 + 2 * lr * k absolute (Adam turns
  a gradient at rounding level into an update of about lr);
- bf16 (``compute_dtype: bfloat16``, f32 masters on both sides): loss
  1e-2 relative, ``grad_norm`` 5e-2, params and EMA as above;
- the initial weights (:func:`init_train_weights`) against JAX's
  ``model.init``: the same all-zero and all-one tensors, per-tensor std
  within 15 % where a tensor has 256 values or more, kernels inside the
  2-std truncation.

Training reaches no kernel and no kernel's plain version: the wrappers
raise when called, and ``launch_counts()`` does not move. A fused flag on
the training model fails on both sides."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DRAW_SEED, TINY_CFG, draw_params

B, M, C = 2, 16, 8  # batch, latents, latent channels of the tiny DiT
CUBE = (32, 32, 32)
LR = 1e-3
STEPS_PER_EPOCH = 4


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _cfg_dict(frozen=False, dtype="float32", **model_overrides):
    d = copy.deepcopy(TINY_CFG)
    d["system"]["compute_dtype"] = dtype
    d["dataset"]["radar"].update(input_r_dim=CUBE[0], input_a_dim=CUBE[1], input_e_dim=CUBE[2])
    d["ar_model"]["configs"].update(enc_radar_r_dim=2, enc_radar_a_dim=2, enc_radar_e_dim=2,
                                    unfreeze_radar_enc=not frozen)
    d["ar_model"]["overrides"].update(model_overrides)
    d["train"].update(lr=LR, epochs=2, warmup_epochs=0, min_lr=1e-6, clip_grad=10)
    if frozen:
        d["radar_enc"] = {"name": "ae_ch16_mult5_n2_d16", "overrides": {"embed_dim": 4}}
    return d


def _cond_input(frozen, rng):
    if frozen:  # the frozen encoder's output: (B, R', A', E', enc_radar_ch)
        return rng.standard_normal((B, 2, 2, 2, 4)).astype(np.float32)
    return rng.standard_normal((B, *CUBE, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_engine(frozen, dtype="float32"):
    """JAX's engine, drawn params, a jitted fresh-state constructor and its train
    step jitted together with the step's own gradients (one compile: the
    in-graph encoder's takes about 12 s). Cached per process."""
    from rald_tpu.config import Config
    from rald_tpu.diffusion.edm import edm_loss
    from rald_tpu.train.gen_engine import GenerationEngine
    from rald_tpu.train.schedule import warmup_cosine_schedule
    from rald_tpu.train.state import create_train_state

    eng = GenerationEngine(Config(_cfg_dict(frozen, dtype)))
    rng = np.random.default_rng(DRAW_SEED)
    shapes = jax.eval_shape(eng.model.init, jax.random.PRNGKey(0), jnp.zeros((1, M, C)),
                            jnp.ones((1,)), jnp.asarray(_cond_input(frozen, rng)[:1]))["params"]
    params = draw_params(shapes, rng)
    k = params["model"]["proj_out"]["kernel"]
    params["model"]["proj_out"]["kernel"] = (rng.standard_normal(k.shape) * 0.2).astype(np.float32)
    sched = warmup_cosine_schedule(LR, 1e-6, 0, 2, STEPS_PER_EPOCH)
    fresh = jax.jit(lambda p: create_train_state(p, sched, clip_grad=10))

    def grads_and_step(state, latents, cube, key):
        def loss_fn(p):
            return edm_loss(lambda x, sigma: eng.model.apply(
                {"params": p}, x, sigma, cube, deterministic=False), key, latents)

        grads = jax.grad(loss_fn)(state.params)
        return (grads, *eng._train_step_impl(state, latents, cube, key))

    return eng, params, fresh, jax.jit(grads_and_step)


def _jax_side(frozen, dtype="float32"):
    """(grads-and-step function, params, a fresh JAX train state on them)."""
    _, params, fresh, step = _jax_engine(frozen, dtype)
    return step, params, fresh(params)


def _torch_side(jstate, frozen, dtype="float32"):
    from rald_torch.config import Config
    from rald_torch.convert.flax_params import train_state_from_flax
    from rald_torch.train.gen_engine import GenerationEngine

    eng = GenerationEngine(Config(_cfg_dict(frozen, dtype)), device="cpu")
    state = eng.init_state(STEPS_PER_EPOCH, B)
    host = jax.device_get((jstate.params, jstate.ema_params, jstate.opt_state, jstate.step))
    return eng, train_state_from_flax(state, *host, depth=2)


def _inputs(frozen, step):
    rng = np.random.default_rng(100 + step)
    latents = rng.standard_normal((B, M, C)).astype(np.float32)
    key = jax.random.PRNGKey(step)
    rs, rn = jax.random.split(key)  # as edm_loss splits its key
    draws = {"rnd": torch.from_numpy(np.array(jax.random.normal(rs, (B, 1, 1)))),
             "noise": torch.from_numpy(np.array(jax.random.normal(rn, (B, M, C))))}
    return latents, _cond_input(frozen, rng), key, draws


def _sd(tree):
    from rald_torch.convert.flax_params import edm_state_dict_from_flax

    return edm_state_dict_from_flax(jax.device_get(tree), depth=2)


def _assert_params(want_tree, got: dict, k: int, lr_sum: float):
    bar = k * 1e-6 + 2 * lr_sum
    want = _sd(want_tree)
    assert sorted(want) == sorted(got)
    worst = max(float((want[n] - got[n]).abs().max()) for n in want)
    assert worst <= bar, (worst, bar)


def test_edm_loss_matches_jax():
    from rald_tpu.diffusion.edm import edm_loss as jax_loss

    from rald_torch.diffusion.edm import edm_loss

    def jax_d(x, s):
        return jnp.tanh(x) * s / (1 + s) + 0.1 * x

    def torch_d(x, s):
        return torch.tanh(x) * s / (1 + s) + 0.1 * x

    y, _, key, draws = _inputs(False, 0)
    want = float(jax_loss(jax_d, key, jnp.asarray(y)))
    got = float(edm_loss(torch_d, torch.from_numpy(y), **draws))
    assert got == pytest.approx(want, rel=1e-5)
    # the same draws from a generator: a finite loss of the same size
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(float(edm_loss(torch_d, torch.from_numpy(y), g)))


@pytest.mark.parametrize("frozen", [False, True], ids=["in_graph_encoder", "frozen_encoder"])
def test_train_steps_match_jax(frozen):
    """Three steps on both sides, each checked, and the gradients of the
    first; after the second step, JAX's state is carried into a fresh port
    engine's state, which takes the third step too."""
    jstep, _, jstate = _jax_side(frozen)
    teng, tstate = _torch_side(jstate, frozen)
    sched = teng.lr_schedule
    lr_sum = 0.0
    for k in range(1, 4):
        latents, cube, key, draws = _inputs(frozen, k)
        x, c = torch.from_numpy(latents), torch.from_numpy(cube)
        if k == 1:
            _assert_grads(jstep(jstate, jnp.asarray(latents), jnp.asarray(cube), key)[0],
                          teng.loss_and_grads(x, c, **draws)[1])
        if k == 3:  # the bridge: JAX's state after two steps
            ceng, carried = _torch_side(jstate, frozen)
            assert carried.step == 2 and carried.count == 2
        _, jstate, jm = jstep(jstate, jnp.asarray(latents), jnp.asarray(cube), key)
        tstate, tm = teng.train_step(tstate, x, c, **draws)
        lr_sum += sched(k - 1)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert tstate.step == int(jstate.step) == k
        _assert_params(jstate.params, tstate.params, k, lr_sum)
        _assert_params(jstate.ema_params, tstate.ema_params, k, lr_sum)
    _, cm = ceng.train_step(carried, x, c, **draws)
    assert float(cm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_params(jstate.params, carried.params, 3, lr_sum)
    _assert_params(jstate.ema_params, carried.ema_params, 3, lr_sum)


def _assert_grads(jax_grads, got: dict):
    want = _sd(jax_grads)
    assert sorted(want) == sorted(got)
    floor = 1e-2 * max(float(v.abs().max()) for v in want.values())
    for name, w in want.items():
        bar = 1e-4 * max(float(w.abs().max()), floor)
        assert float((got[name] - w).abs().max()) <= bar, name


def test_bf16_train_step_matches_jax():
    jstep, _, jstate = _jax_side(False, "bfloat16")
    teng, tstate = _torch_side(jstate, False, "bfloat16")
    assert next(teng.train_model.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tstate.params.values())
    latents, cube, key, draws = _inputs(False, 1)
    _, jstate, jm = jstep(jstate, jnp.asarray(latents), jnp.asarray(cube), key)
    tstate, tm = teng.train_step(tstate, torch.from_numpy(latents), torch.from_numpy(cube), **draws)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-2)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=5e-2)
    _assert_params(jstate.params, tstate.params, 1, LR)
    _assert_params(jstate.ema_params, tstate.ema_params, 1, LR)
    # the working copy is the masters, rounded
    for name, p in teng.train_model.named_parameters():
        torch.testing.assert_close(p, tstate.params[name].to(torch.bfloat16), rtol=0, atol=0)


def test_initial_weights_match_jax_init():
    """JAX's ``model.init`` of the frozen-encoder DiT (no 3D-CNN: its init
    compiles in a second), and for the in-graph encoder's convolutions the
    initializer flax's ``nn.Conv`` uses (lecun normal) on their shapes."""
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    jeng = _jax_engine(True)[0]
    rng = np.random.default_rng(0)
    init = jax.jit(jeng.model.init)(jax.random.PRNGKey(3), jnp.zeros((1, M, C)), jnp.ones((1,)),
                                    jnp.asarray(_cond_input(True, rng)[:1]))["params"]
    want = _sd(init)
    for frozen in (True, False):
        got = GenerationEngine(Config(_cfg_dict(frozen)), device="cpu").init_state(
            STEPS_PER_EPOCH, B).params
        if not frozen:  # the encoder's tensors, drawn by flax's initializers
            enc = {k: v for k, v in got.items() if k.startswith("radar_enc.")}
            convs = [k for k, v in enc.items() if v.ndim == 5]
            shapes = [(*enc[k].shape[2:], enc[k].shape[1], enc[k].shape[0]) for k in convs]
            kernels = jax.jit(lambda key: [jax.nn.initializers.lecun_normal()(sub, shape) for sub, shape
                                           in zip(jax.random.split(key, len(shapes)), shapes)])(
                jax.random.PRNGKey(4))
            for name, w in zip(convs, kernels):
                want[name] = torch.from_numpy(np.array(w)).permute(4, 3, 0, 1, 2)
            for name, g in enc.items():
                if g.ndim != 5:
                    norm_scale = ".norm" in name and name.endswith(".weight")
                    want[name] = torch.ones_like(g) if norm_scale else torch.zeros_like(g)
        assert sorted(want) == sorted(got), frozen
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape, name
            assert bool((w == 0).all()) == bool((g == 0).all()), name
            assert bool((w == 1).all()) == bool((g == 1).all()), name
            if w.numel() >= 256 and float(w.std()) > 0:
                assert float(g.std()) == pytest.approx(float(w.std()), rel=0.15), name
            if name.endswith("weight") and "_emb" not in name and float(w.std()) > 0:
                limit = 2 * w[0].numel() ** -0.5 / 0.87962566103423978
                assert float(g.abs().max()) <= limit + 1e-6, name
        assert bool((got["model.proj_out.weight"] == 0).all())


def test_train_step_reaches_no_kernel(monkeypatch):
    import rald_torch.models.latent_dit as dit
    import rald_torch.models.vecset_vae as vae
    import rald_torch.nn.layers as layers
    from rald_torch.ops import launch_counts

    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    teng = GenerationEngine(Config(_cfg_dict()), device="cpu")
    tstate = teng.init_state(STEPS_PER_EPOCH, B)
    teng.model.set_flags(use_fused_ff=True, use_fused_attn=True)  # the eval DiT's flags only

    def refuse(*a, **k):
        raise AssertionError("the training path called a kernel wrapper")

    for mod in (dit, vae, layers):
        for name in dir(mod):
            if name.startswith(("fused_", "geglu_ff")):
                monkeypatch.setattr(mod, name, refuse)
    before = launch_counts()
    latents, cube, _, draws = _inputs(False, 1)
    _, m = teng.train_step(tstate, torch.from_numpy(latents), torch.from_numpy(cube), **draws)
    assert np.isfinite(float(m["loss"]))
    assert launch_counts() == before


@pytest.mark.parametrize("flag", ["use_fused_ff", "use_fused_attn"])
def test_fused_flag_on_training_model_fails_on_both_sides(flag):
    from rald_tpu.config import Config as JConfig
    from rald_tpu.train.gen_engine import GenerationEngine as JEngine

    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    _, _, jstate = _jax_side(True)
    jeng = JEngine(JConfig(_cfg_dict(True, **{flag: True})))
    latents, cube, key, _ = _inputs(True, 1)
    with pytest.raises(ValueError, match="reverse-mode"):
        jeng._train_step(jstate, jnp.asarray(latents), jnp.asarray(cube), key)
    eng = GenerationEngine(Config(_cfg_dict(True, **{flag: True})), device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        eng.init_state(STEPS_PER_EPOCH, B)
