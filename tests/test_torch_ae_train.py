"""Stage-1 VAE training and evaluation: ``rald_torch.train.ae_engine.AEEngine``
against ``rald_tpu.train.ae_engine.AEEngine`` on the CPU, float32 with
``matmul_precision: highest``, at a tiny size (VAE depth 2, dim 64, 16
latents x 8 channels, 64 points and 64 queries a frame, batch 2).

JAX's draws are injected into the port: the posterior noise is
``jax.random.normal`` of the key flax's ``make_rng("latent")`` yields at the
root scope (rebuilt with a one-line flax module on the same stream key),
and the per-sample keep masks of every drop-path are recorded on the JAX
side by ``flax.linen.intercept_methods`` around ``DropPath.__call__``,
which draws them from the module's own ``make_rng("dropout")`` as
``DropPath`` does (the intercepted forward equals the plain one bitwise).
The port's own generator-driven masks are compared by distribution.

Bars:

- ``DropPath`` with a given mask: bitwise equal to JAX's in f32 and bf16;
  drawn masks: the dropped share within 5 sigma of 0.1, kept values
  ``x / keep``;
- ``VecSetVAE.forward`` (eval and training mode): logits and KL within
  1e-5 of max |out|;
- ``loss_and_metrics`` (training and eval model): each metric 1e-5
  relative;
- three train steps from one JAX train state carried by the bridge
  (``train_state_from_flax`` with ``vae_state_dict_from_flax``): loss
  1e-5 relative, ``grad_norm`` 1e-4, step 1's gradients 1e-4 of each
  tensor's max |g| (the max floored at 1e-2 of the largest), params and
  EMA after k steps within k * 1e-6 + 2 * lr * k absolute; bf16 (f32
  masters on both sides): loss 1e-2 relative, ``grad_norm`` 5e-2, params
  and EMA as above;
- the initial weights against JAX's ``model.init``: the same all-zero and
  all-one tensors, per-tensor std within 15 % where a tensor has 256
  values or more, kernels inside the 2-std truncation, the query tables
  N(0, 1);
- ``lr_decay_scales`` and ``scale_by_layer_decay``: exactly JAX's, leaf by
  leaf through the tree converters;
- ``evaluate`` on a 3-batch loader, in four configurations that cover
  every branch (params / EMA, ``eval.freq`` 1 / 2, the polar / cartesian
  grid, ``iou_test_onlytest``): loss / IoU / accuracy 1e-5, the same
  thresholded grid points (1e-5), ``cd`` / ``fscore`` 1e-5. JAX's Chamfer
  runs its exact Pallas kernel in interpret mode, as in
  ``tests/test_torch_evaluate.py``.

A fused FF on the training model fails on both sides; the train step
reaches no kernel wrapper."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import draw_params, jax_exact_chamfer

B, N, LR, STEPS_PER_EPOCH = 2, 64, 1e-3, 4
# step keys whose drop-path draws drop at least one sample (most keys drop
# none: 5 sites x 2 samples at rate 0.1)
FORWARD_KEY, METRICS_KEY, STEP_KEYS, BF16_KEY = 10, 5, (9, 10, 15), 17
DEPTH, M, C = 2, 16, 8
VAE = dict(dim=64, queries_dim=64, depth=DEPTH, num_latents=M, latent_dim=C, heads=4, dim_head=16)
CFG = {
    "system": {"seed": 0, "compute_dtype": "float32"},
    "dataset": {
        "lidar": {
            "pc_range": [0, -90, -20, 15.8, 90, 20], "pc_range_cart": [0, -15, -5, 15, 15, 5],
            "voxel_size": [0.05, 0.25, 0.5],
            "num_samples": N, "query_ratio": 0.0625, "norm_isotropy": False,
            "norm_anisotropy": True, "view_cone_mode": True,
        },
    },
    "train": {"epochs": 2, "lr": LR, "min_lr": 1e-6, "warmup_epochs": 0, "clip_grad": 10,
              "vol_weight": 0.1, "near_weight": 1.0},
    "lidar_ae": {"name": "kl_d512_m512_l32_mix", "point_cloud_size": N, "overrides": VAE},
    "eval": {"fscore_tau": 0.1, "freq": 1, "inference": {"num_query_points": 512}},
}


@pytest.fixture(autouse=True)
def _highest():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _cfg_dict(dtype="float32", eval_updates=(), **overrides):
    d = copy.deepcopy(CFG)
    d["system"]["compute_dtype"] = dtype
    d["lidar_ae"]["overrides"].update(overrides)
    d["eval"].update(dict(eval_updates))
    return d


def _jax_engine_for(d):
    from rald_tpu.config import Config
    from rald_tpu.parallel.mesh import make_mesh
    from rald_tpu.train.ae_engine import AEEngine

    return AEEngine(Config(d), mesh=make_mesh(jax.devices()[:1]))


@functools.lru_cache(maxsize=None)
def _jax_engine(dtype="float32"):
    """JAX's engine, drawn params (``model.init``'s tree), a jitted fresh-state
    constructor, its train step jitted with the step's own gradients, and a
    jitted draw recorder. Cached per process."""
    from rald_tpu.train.schedule import warmup_cosine_schedule
    from rald_tpu.train.state import create_train_state

    eng = _jax_engine_for(_cfg_dict(dtype))
    key = jax.random.PRNGKey(0)
    pc, q = jnp.zeros((1, N, 3)), jnp.zeros((1, N, 3))
    params = draw_params(jax.eval_shape(eng.model.init, {"params": key, "latent": key}, pc, q)[
        "params"], np.random.default_rng(7))
    sched = warmup_cosine_schedule(LR, 1e-6, 0, 2, STEPS_PER_EPOCH)
    fresh = jax.jit(lambda p: create_train_state(p, sched, clip_grad=10))

    def grads_and_step(state, batch, rng):
        grads = jax.grad(lambda p: eng._loss_and_metrics(p, batch, rng, deterministic=False)[0])(
            state.params)
        return (grads, *eng._train_step_impl(state, batch, rng))

    return eng, params, fresh, jax.jit(grads_and_step), jax.jit(functools.partial(_record, eng))


def _root_key(stream_key):
    """The key flax's ``make_rng`` yields first at the root scope of a
    module applied with ``rngs={"latent": stream_key}``."""
    from flax import linen as nn

    class _Key(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("latent")

    return _Key().apply({}, rngs={"latent": stream_key})


def _port_site(path) -> str:
    """A JAX drop-path's module path -> the port's module name."""
    if path[0] == "mix_attn":
        return "mix_attn_layer.fn.drop_path"
    return f"layers.{int(path[0].split('_')[1])}.{0 if path[1] == 'attn' else 1}.fn.drop_path"


def _record(eng, params, pc, q, rng):
    """JAX's training forward of a step key (``_loss_and_metrics``'s rngs),
    with every drop-path's mask recorded: ``(logits, posterior noise,
    {port site: (B,) mask})``."""
    from flax import linen as nn
    from rald_tpu.nn.layers import DropPath

    masks = {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, DropPath) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        det = args[1] if len(args) > 1 else kwargs.get("deterministic", True)
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        keep = 1.0 - mod.rate  # DropPath.__call__'s own draw and output
        mask = jax.random.bernoulli(mod.make_rng("dropout"), keep,
                                    (x.shape[0],) + (1,) * (x.ndim - 1))
        masks[_port_site(mod.path)] = mask.reshape(-1)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    rngs = {"latent": jax.random.fold_in(rng, 0), "dropout": jax.random.fold_in(rng, 1)}
    with nn.intercept_methods(interceptor):
        out = eng.model.apply({"params": params}, pc, q, rngs=rngs, deterministic=False)
    eps = jax.random.normal(_root_key(rngs["latent"]), (pc.shape[0], M, C))
    return out["logits"], eps, masks


def _batch(step, n_batch=B):
    rng = np.random.default_rng(100 + step)
    k = int(N * 0.0625)
    labels = np.zeros((n_batch, N), np.float32)
    labels[:, :k] = 1.0
    labels[:, k:] = rng.random((n_batch, N - k)) < 0.2
    return {"lidar_points": rng.uniform(-0.9, 0.9, (n_batch, N, 3)).astype(np.float32),
            "query_points": rng.uniform(-1, 1, (n_batch, N, 3)).astype(np.float32),
            "query_labels": labels}


def _draws(step, params=None):
    """A step's batch, key and JAX's draws as torch tensors."""
    _, p0, _, _, record = _jax_engine()
    batch, rng = _batch(step), jax.random.PRNGKey(step)
    _, eps, masks = record(p0 if params is None else params, batch["lidar_points"],
                           batch["query_points"], rng)
    return batch, rng, torch.from_numpy(np.array(eps)), {
        k: torch.from_numpy(np.array(v)) for k, v in masks.items()}


def _sd(tree):
    from rald_torch.convert.flax_params import vae_state_dict_from_flax

    return vae_state_dict_from_flax(jax.device_get(tree), depth=DEPTH, query_type="mix")


def _torch_side(jstate, dtype="float32", **cfg):
    from rald_torch.config import Config
    from rald_torch.convert.flax_params import train_state_from_flax, vae_state_dict_from_flax
    from rald_torch.train.ae_engine import AEEngine

    eng = AEEngine(Config(_cfg_dict(dtype, **cfg)), device="cpu")
    state = eng.init_state(STEPS_PER_EPOCH, B)
    host = jax.device_get((jstate.params, jstate.ema_params, jstate.opt_state, jstate.step))
    convert = functools.partial(vae_state_dict_from_flax, depth=DEPTH, query_type="mix")
    return eng, train_state_from_flax(state, *host, convert=convert)


def _close(got, want, rel, what):
    got, want = float(got), float(want)
    assert got == pytest.approx(want, rel=rel, abs=1e-12), what


# ----------------------------------------------------------------- DropPath
def test_drop_path_matches_jax_with_its_mask():
    from flax import linen as nn
    from rald_tpu.nn.layers import DropPath as JDropPath

    from rald_torch.nn.layers import DropPath

    class _Key(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout")

    x = np.random.default_rng(0).standard_normal((64, 5, 7)).astype(np.float32)
    stream = jax.random.PRNGKey(3)
    mask = np.array(jax.random.bernoulli(_Key().apply({}, rngs={"dropout": stream}), 0.9,
                                         (64, 1, 1))).reshape(-1)
    assert 0 < mask.sum() < 64
    port = DropPath(0.1)
    port.mask = torch.from_numpy(mask)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JDropPath(0.1).apply({}, jnp.asarray(x, jdt), False, rngs={"dropout": stream})
        got = port(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        assert torch.equal(got.float(), torch.from_numpy(np.array(want.astype(jnp.float32))))
    xt = torch.from_numpy(x)
    assert port.eval()(xt) is xt  # not training: the identity
    assert DropPath(0.0).train()(xt) is xt


def test_drop_path_draws_by_distribution():
    from rald_torch.models.vecset_vae import VecSetVAE
    from rald_torch.nn.layers import DropPath

    dp = DropPath(0.1)
    dp.generator = torch.Generator().manual_seed(0)
    x = torch.ones(40000, 3, 2)
    y = dp(x)
    dropped = (y == 0).all(dim=(1, 2))
    share = float(dropped.float().mean())
    assert abs(share - 0.1) <= 5 * (0.1 * 0.9 / 40000) ** 0.5, share
    kept = y[~dropped]
    assert torch.equal(kept, torch.full_like(kept, float(torch.tensor(1.0) / torch.tensor(0.9))))
    dp.generator = torch.Generator().manual_seed(0)
    assert torch.equal(dp(x), y)  # the generator decides
    dp.generator = torch.Generator().manual_seed(1)
    assert not torch.equal(dp(x), y)
    # the VAE's sites: both sublayers of every block and the mix attention
    vae = VecSetVAE(num_inputs=N, **VAE)
    sites = vae.drop_paths()
    assert sorted(sites) == sorted(
        [f"layers.{i}.{j}.fn.drop_path" for i in range(DEPTH) for j in (0, 1)]
        + ["mix_attn_layer.fn.drop_path"])
    assert all(m.rate == 0.1 for m in sites.values())
    for name in ("cross_attend_blocks.0.fn", "cross_attend_blocks.1.fn", "decoder_cross_attn.fn"):
        assert vae.get_submodule(name).drop_path.rate == 0.0


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(mode):
    from rald_torch.models.vecset_vae import VecSetVAE

    jeng, params, *_ = _jax_engine()
    batch, rng, eps, masks = _draws(FORWARD_KEY)
    model = VecSetVAE(num_inputs=N, **VAE)
    model.load_state_dict(_sd(params))
    pc, q = batch["lidar_points"], batch["query_points"]
    if mode == "train":
        want = jax.jit(functools.partial(jeng.model.apply, deterministic=False))(
            {"params": params}, pc, q, rngs={"latent": jax.random.fold_in(rng, 0),
                                             "dropout": jax.random.fold_in(rng, 1)})
        assert not all(bool(m.all()) for m in masks.values())  # some sample drops
        got = model.train()(torch.from_numpy(pc), torch.from_numpy(q), eps=eps, drop_masks=masks)
    else:
        key = jax.random.PRNGKey(9)
        want = jax.jit(jeng.model.apply)({"params": params}, pc, q, rng=key)
        got = model.eval()(torch.from_numpy(pc), torch.from_numpy(q),
                           eps=torch.from_numpy(np.array(jax.random.normal(key, (B, M, C)))))
    for k in ("logits", "kl"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32
        err = float(np.abs(got[k].detach().numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_loss_and_metrics_match_jax(mode):
    jeng, params, fresh, *_ = _jax_engine()
    batch, rng, eps, masks = _draws(METRICS_KEY)
    teng, _ = _torch_side(fresh(params))
    if mode == "train":
        _, want = jax.jit(functools.partial(jeng._loss_and_metrics, deterministic=False))(
            params, batch, rng)
        _, got = teng.loss_and_metrics(teng.train_model, batch, eps=eps, drop_masks=masks)
    else:  # the eval model (folded decode tail), JAX's _eval_step
        want = jeng._eval_step(params, batch, rng)
        teng.load_eval_params(_sd(params))
        eps = np.array(jax.random.normal(_root_key(jax.random.fold_in(rng, 0)), (B, M, C)))
        _, got = teng.loss_and_metrics(teng.model_eval, batch, eps=eps)
    assert sorted(got) == sorted(want) == sorted(
        ["loss", "loss_vol", "loss_near", "loss_kl", "iou", "accuracy"])
    for k in want:
        _close(got[k], want[k], 1e-5, k)


# -------------------------------------------------------------- train steps
def _assert_params(want_tree, got: dict, k: int, lr_sum: float):
    bar = k * 1e-6 + 2 * lr_sum
    want = _sd(want_tree)
    assert sorted(want) == sorted(got)
    worst = max(float((want[n] - got[n]).abs().max()) for n in want)
    assert worst <= bar, (worst, bar)


def _assert_grads(jax_grads, got: dict):
    want = _sd(jax_grads)
    assert sorted(want) == sorted(got)
    floor = 1e-2 * max(float(v.abs().max()) for v in want.values())
    for name, w in want.items():
        bar = 1e-4 * max(float(w.abs().max()), floor)
        assert float((got[name] - w).abs().max()) <= bar, name


def test_train_steps_match_jax():
    """Three steps on both sides, each checked, and the gradients of the
    first; after the second step, JAX's state is carried into a fresh port
    engine's state, which takes the third step too."""
    _, params, fresh, jstep, _ = _jax_engine()
    jstate = fresh(params)
    teng, tstate = _torch_side(jstate)
    lr_sum = 0.0
    for k, key in enumerate(STEP_KEYS, start=1):
        batch, rng, eps, masks = _draws(key)
        assert not all(bool(m.all()) for m in masks.values())
        if k == 1:
            _assert_grads(jstep(jstate, batch, rng)[0],
                          teng.loss_and_grads(batch, eps=eps, drop_masks=masks)[1])
        if k == 3:  # the bridge: JAX's state after two steps
            ceng, carried = _torch_side(jstate)
            assert carried.step == 2 and carried.count == 2
        _, jstate, jm = jstep(jstate, batch, rng)
        tstate, tm = teng.train_step(tstate, batch, eps=eps, drop_masks=masks)
        lr_sum += teng.lr_schedule(k - 1)
        assert sorted(tm) == sorted(jm)
        _close(tm["loss"], jm["loss"], 1e-5, "loss")
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4, "grad_norm")
        assert tstate.step == int(jstate.step) == k
        _assert_params(jstate.params, tstate.params, k, lr_sum)
        _assert_params(jstate.ema_params, tstate.ema_params, k, lr_sum)
    _, cm = ceng.train_step(carried, batch, eps=eps, drop_masks=masks)
    _close(cm["loss"], jm["loss"], 1e-5, "carried loss")
    _assert_params(jstate.params, carried.params, 3, lr_sum)
    _assert_params(jstate.ema_params, carried.ema_params, 3, lr_sum)


def test_bf16_train_step_matches_jax():
    _, params, fresh, jstep, _ = _jax_engine("bfloat16")
    jstate = fresh(params)
    teng, tstate = _torch_side(jstate, "bfloat16")
    assert next(teng.train_model.parameters()).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tstate.params.values())
    batch, rng, eps, masks = _draws(BF16_KEY)
    _, jstate, jm = jstep(jstate, batch, rng)
    tstate, tm = teng.train_step(tstate, batch, eps=eps, drop_masks=masks)
    _close(tm["loss"], jm["loss"], 1e-2, "loss")
    _close(tm["grad_norm"], jm["grad_norm"], 5e-2, "grad_norm")
    _assert_params(jstate.params, tstate.params, 1, LR)
    _assert_params(jstate.ema_params, tstate.ema_params, 1, LR)
    # the working copy is the masters, rounded
    for name, p in teng.train_model.named_parameters():
        torch.testing.assert_close(p, tstate.params[name].to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("query_type", ["mix", "learnable"])
def test_initial_weights_match_jax_init(query_type):
    from rald_torch.config import Config
    from rald_torch.convert.flax_params import vae_state_dict_from_flax
    from rald_torch.train.ae_engine import AEEngine

    jeng = _jax_engine_for(_cfg_dict(query_type=query_type))
    key = jax.random.PRNGKey(3)
    init = jax.jit(jeng.model.init)({"params": key, "latent": key}, jnp.zeros((1, N, 3)),
                                     jnp.zeros((1, 8, 3)))["params"]
    want = vae_state_dict_from_flax(jax.device_get(init), depth=DEPTH, query_type=query_type)
    got = AEEngine(Config(_cfg_dict(query_type=query_type)), device="cpu").init_state(
        STEPS_PER_EPOCH, B).params
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool((w == 0).all()) == bool((g == 0).all()), name
        assert bool((w == 1).all()) == bool((g == 1).all()), name
        if w.numel() >= 256 and float(w.std()) > 0:
            assert float(g.std()) == pytest.approx(float(w.std()), rel=0.15), name
        if name.endswith("weight") and w.ndim == 2 and "latents" not in name:
            limit = 2 * w.shape[1] ** -0.5 / 0.87962566103423978
            assert float(g.abs().max()) <= limit + 1e-6, name
    tables = ["s_latents.weight", "d_latents.weight"] if query_type == "mix" else ["latents.weight"]
    for name in tables:  # flax's normal(1.0)
        assert float(got[name].std()) == pytest.approx(1.0, rel=0.15)
        assert float(want[name].std()) == pytest.approx(1.0, rel=0.15)


# ---------------------------------------------------------------- lr decay
def _broadcast_scales(scales, params):
    return jax.tree_util.tree_map(lambda s, p: np.full(np.shape(p), s, np.float32), scales, params)


@pytest.mark.parametrize("model", ["vae", "dit"])
def test_lr_decay_scales_match_jax(model):
    """JAX's scales of each leaf, through the tree converter, against the
    port's by parameter name. JAX's ``layer_id_fn`` reads the top module of
    the tree it gets: the VAE's own tree, and for the DiT the transformer
    under ``EDMPrecond``'s ``model`` (its other top-level modules, the
    radar encoder and token projection, at ``depth + 1``)."""
    from rald_tpu.train.lr_decay import lr_decay_scales as jax_scales
    from rald_tpu.train.lr_decay import scale_by_layer_decay as jax_transform

    from rald_torch.convert.flax_params import edm_state_dict_from_flax
    from rald_torch.train.lr_decay import lr_decay_scales, scale_by_layer_decay

    if model == "vae":
        params = _jax_engine()[1]
        want = _sd(_broadcast_scales(jax_scales(params, DEPTH, 0.75), params))
    else:
        from torch_parity import jax_engine_and_params

        params = jax_engine_and_params(0)[1]
        tree = jax_scales(params, DEPTH, 0.75)
        tree["model"] = jax_scales(params["model"], DEPTH, 0.75)
        want = edm_state_dict_from_flax(_broadcast_scales(tree, params), depth=DEPTH)
    got = lr_decay_scales(want, DEPTH, 0.75)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert bool((w == got[name]).all()), (name, float(w.flatten()[0]), got[name])
    assert len({round(s, 12) for s in got.values()}) == DEPTH + 2  # every layer id occurs
    if model == "vae":  # the transform on the same updates
        rng = np.random.default_rng(0)
        updates = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        tx = jax_transform(params, DEPTH, 0.75)
        out, _ = tx.update(updates, tx.init(params))
        mine = scale_by_layer_decay(_sd(updates), DEPTH, 0.75)
        for name, w in _sd(out).items():
            assert torch.equal(mine[name], w), name


# ----------------------------------------------------------------- evaluate
def _sharpened(jeng, params):
    """Random decoder weights give nearly one logit to every query of a
    frame: the query projection x10 spreads them, and the occupancy bias
    moves their median over a grid to 0, so about half the grid is hit."""
    from rald_tpu.eval.queries import build_query_grid

    p = jax.tree_util.tree_map(np.array, params)
    p["dec_cross_attn"]["to_q"]["kernel"] *= 10
    grid = build_query_grid(jeng.cfg.dataset.lidar, 512, False, np.random.default_rng(0))
    logits = jeng._forward_logits(p, _batch(40)["lidar_points"],
                                  np.broadcast_to(grid, (B, 512, 3)), jax.random.PRNGKey(0))
    p["to_outputs"]["bias"] -= np.float32(np.median(np.asarray(logits)))
    return p


EVAL_CASES = {
    "params": {},
    "ema_freq2": {"use_ema": True, "freq": 2},
    "cart_grid": {"use_cart_query": True},
    "iou_test_onlytest": {"iou_test_onlytest": True},
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluate_matches_jax(case, monkeypatch):
    """One JAX train step, so the EMA differs from the params; then both
    engines' ``evaluate`` on a 3-batch loader, the port with JAX's two
    posterior draws per evaluated batch (``eval_eps``)."""
    import rald_tpu.train.ae_engine as jae

    import rald_torch.train.ae_engine as tae

    opts = dict(EVAL_CASES[case])
    use_ema = opts.pop("use_ema", False)
    eval_updates = {**CFG["eval"], **opts}
    _, params, fresh, jstep, _ = _jax_engine()
    batch, rng, _, _ = _draws(30)
    jeng = _jax_engine_for(_cfg_dict(eval_updates=eval_updates))
    _, jstate, _ = jstep(fresh(_sharpened(jeng, params)), batch, rng)
    teng, tstate = _torch_side(jstate, eval_updates=eval_updates)
    base = jax.random.PRNGKey(teng.seed + 7)
    teng.eval_eps = lambda it, which, shape: torch.from_numpy(np.array(jax.random.normal(
        _root_key(jax.random.fold_in(jax.random.fold_in(base, it), which)), shape)))
    loader = [_batch(40 + i) for i in range(3)]

    clouds = {"jax": [], "torch": []}

    def recording(side, fn):
        def wrapped(preds, gts, *a, **k):
            clouds[side].append((preds, gts))
            return fn(preds, gts, *a, **k)
        return wrapped

    monkeypatch.setattr(jae, "chamfer_and_fscore_batch",
                        recording("jax", jae.chamfer_and_fscore_batch))
    monkeypatch.setattr(tae, "chamfer_and_fscore_batch",
                        recording("torch", tae.chamfer_and_fscore_batch))
    with jax_exact_chamfer():
        want = jeng.evaluate(jstate, loader, use_ema=use_ema, print_fn=lambda *_: None)
    lines = []
    got = teng.evaluate(tstate, loader, use_ema=use_ema, print_fn=lines.append)
    assert lines[0] == f"Using {'EMA' if use_ema else 'model'} parameters for evaluation"
    assert lines[-1].startswith("* iou ")
    assert sorted(got) == sorted(want)
    n_eval = 2 if opts.get("freq") == 2 else 3
    assert len(clouds["torch"]) == len(clouds["jax"]) == (0 if "iou_test_onlytest" in opts
                                                          else n_eval)
    if not clouds["torch"]:
        assert "cd" not in got
    for (tp, tg), (jp, jg) in zip(clouds["torch"], clouds["jax"]):
        for a, b in zip(tp + tg, jp + jg):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert all(len(p) for p in tp)  # the grid has positives to score
    for k in want:
        _close(got[k], want[k], 1e-5, k)


# ------------------------------------------------------------- refusals
def test_fused_ff_training_model_fails_on_both_sides():
    from rald_torch.config import Config
    from rald_torch.train.ae_engine import AEEngine

    _, params, fresh, _, _ = _jax_engine()
    jeng = _jax_engine_for(_cfg_dict(use_fused_ff=True))
    batch, rng, eps, masks = _draws(3)
    with pytest.raises(ValueError, match="reverse-mode"):
        jeng._train_step(fresh(params), batch, rng)
    eng = AEEngine(Config(_cfg_dict(use_fused_ff=True)), device="cpu")
    state = eng.init_state(STEPS_PER_EPOCH, B)
    with pytest.raises(ValueError, match="inference-only"):
        eng.train_step(state, batch, eps=eps, drop_masks=masks)


def test_train_step_reaches_no_kernel(monkeypatch):
    import rald_torch.models.vecset_vae as vae
    import rald_torch.nn.layers as layers
    from rald_torch.config import Config
    from rald_torch.ops import launch_counts
    from rald_torch.train.ae_engine import AEEngine

    eng = AEEngine(Config(_cfg_dict()), device="cpu")
    state = eng.init_state(STEPS_PER_EPOCH, B)

    def refuse(*a, **k):
        raise AssertionError("the training path called a kernel wrapper")

    for mod in (vae, layers):
        for name in dir(mod):
            if name.startswith(("fused_", "geglu_ff")):
                monkeypatch.setattr(mod, name, refuse)
    before = launch_counts()
    state, m = eng.train_step(state, _batch(4), eng.step_generator(0, 0))
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert launch_counts() == before


def test_train_one_epoch_logs_and_guards_nonfinite_losses():
    """The TensorBoard tags of JAX's ``train_one_epoch`` at ``epoch_1000x``,
    the averaged metrics, and a non-finite loss: exit 1, or with
    ``skip_nonfinite_updates`` a warning and a skipped update."""
    from rald_torch.config import Config
    from rald_torch.train.ae_engine import AEEngine
    from rald_torch.train.metrics import epoch_1000x

    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, value, step))

    eng = AEEngine(Config(_cfg_dict()), device="cpu")
    state = eng.init_state(2, B)
    writer, lines = Writer(), []
    state, stats = eng.train_one_epoch(state, [_batch(50), _batch(51)], 1, log_writer=writer,
                                       print_fn=lines.append)
    tags = ["loss", "vol_loss", "near_loss", "kl_loss", "iou", "accuracy", "norm", "lr"]
    assert [t for t, _, _ in writer.calls] == tags * 2
    assert [s for _, _, s in writer.calls] == [epoch_1000x(1.0)] * 8 + [epoch_1000x(1.5)] * 8
    assert state.step == 2 and sorted(stats) == sorted(
        ["loss", "loss_vol", "loss_near", "loss_kl", "iou", "accuracy", "grad_norm", "lr"])
    assert lines[-1].startswith("Averaged stats:")
    bad = _batch(52)
    bad["lidar_points"][0, 0] = np.nan
    with pytest.raises(SystemExit):
        eng.train_one_epoch(state, [bad], 0, print_fn=lines.append)
    assert lines[-1].startswith("Loss is nan")
    d = _cfg_dict()
    d["train"]["skip_nonfinite_updates"] = True
    skip = AEEngine(Config(d), device="cpu")
    st = skip.init_state(2, B)
    before = {k: v.clone() for k, v in st.params.items()}
    st, _ = skip.train_one_epoch(st, [bad], 0, print_fn=lines.append)
    assert any(line.startswith("WARNING: non-finite loss") for line in lines)
    assert st.step == 1 and all(torch.equal(before[k], v) for k, v in st.params.items())
