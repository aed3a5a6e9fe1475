"""Shared set-up for the ``test_torch_*`` parity tests: the tiny generation
config, flax parameters in ``model.init``'s tree and distributions, and
carried into the port through ``rald_torch.convert.flax_params``."""
from __future__ import annotations

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

# The suite runs in several pytest-xdist workers on one machine, and every
# worker imports this module while it collects. Torch's default of one
# intra-op thread per core then oversubscribes the cores, and the tiny ops
# of these tests spend most of their time handing work between threads:
# one thread per worker.
torch.set_num_threads(1)

TINY_CFG = {
    "system": {"seed": 0, "compute_dtype": "float32"},
    "dataset": {
        "lidar": {
            "pc_range": [0, -90, -20, 15.8, 90, 20],
            "voxel_size": [0.05, 0.25, 0.5],
            "num_samples": 512,
            "norm_isotropy": False,
            "norm_anisotropy": True,
            "view_cone_mode": True,
        },
        "radar": {
            "input_r_dim": 32, "input_a_dim": 16, "input_e_dim": 16, "input_ch": 3,
            "upsample": False,
        },
        "query_aug_num": 256,
        "query_aug_scale": 2,
    },
    "train": {"epochs": 1, "lr": 1e-3, "blr": 1e-3, "min_lr": 1e-6, "clip_grad": 10},
    "ar_model": {
        "name": "kl_d512_m512_l32_d24_edm",
        "configs": {
            "cond_type": "radar", "use_radar_cond": True, "use_radar_enc": True,
            "unfreeze_radar_enc": True, "radar_token_channel": 32,
            "enc_radar_r_dim": 2, "enc_radar_a_dim": 1, "enc_radar_e_dim": 1,
            "enc_radar_ch": 4, "enc_hidden_ch": 8,
        },
        "overrides": {"n_latents": 16, "channels": 8, "depth": 2, "n_heads": 2, "d_head": 16},
    },
    "lidar_ae": {
        "name": "kl_d512_m512_l32_mix",
        "latent_std": 1,
        "overrides": {
            "dim": 64, "queries_dim": 64, "depth": 2, "num_latents": 16,
            "latent_dim": 8, "heads": 4, "dim_head": 16,
        },
    },
    "eval": {
        "fscore_tau": 0.1,
        "inference": {
            "num_query_points": 1024, "refine_query_aug_num": 512, "refine_query_scale": 2,
        },
    },
}


# numpy seed of the parameter draws: the tiny radar encoder's last GroupNorm
# normalises 1 channel x 2 positions, so f32 noise can become condition-
# token differences of several percent on some cubes; with these weights
# the tests' cubes condition to <= 1e-4 on both sides
DRAW_SEED = 6


def tiny_cfg(cfg_cls, **updates):
    d = copy.deepcopy(TINY_CFG)
    for k, v in updates.items():
        d[k].update(v)
    return cfg_cls(d)


def draw_params(shapes, rng: np.random.Generator):
    """Parameters for the tree of ``jax.eval_shape(model.init, ...)``, drawn
    with numpy in flax's default distributions: kernels N(0, 1/fan_in)
    (lecun normal, untruncated), zero biases, unit norm scales, N(0, 1)
    for the raw tables (embeddings, latent queries). Tracing the init costs
    about a second; compiling it (the 3D-CNN's convolutions) ten or more."""
    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * fan_in ** -0.5).astype(np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        return rng.standard_normal(leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_engine_and_params(seed: int = 0):
    """rald_tpu's engine on the tiny config with parameters in ``model.init``'s
    tree (:func:`draw_params`; the zero-initialized DiT out-projection gets
    random values, so the sampler's denoiser output is not identically
    zero). Cached per process: callers must not mutate the returned trees."""
    from rald_tpu.config import Config
    from rald_tpu.train.gen_engine import GenerationEngine

    eng = GenerationEngine(tiny_cfg(Config))
    m = eng.model
    # parameter shapes do not depend on the cube's spatial size, so init on
    # a 16^3 cube (the 3D-CNN's smallest input) to keep set-up cheap
    rng = np.random.default_rng(DRAW_SEED + seed)
    params = draw_params(jax.eval_shape(
        m.init, jax.random.PRNGKey(seed), jnp.zeros((1, m.n_latents, m.channels)), jnp.ones((1,)),
        jnp.zeros((1, 16, 16, 16, 3)),
    )["params"], rng)
    k = params["model"]["proj_out"]["kernel"]
    params["model"]["proj_out"]["kernel"] = (rng.standard_normal(k.shape) * 0.2).astype(np.float32)
    vae_params = draw_params(jax.eval_shape(eng.init_vae_params, jax.random.PRNGKey(seed + 1)), rng)
    return eng, params, vae_params


def torch_engine(params, vae_params, **cfg_updates):
    """The port's engine on the CPU with the same (carried-over) weights."""
    from rald_torch.config import Config
    from rald_torch.convert.flax_params import edm_state_dict_from_flax, vae_state_dict_from_flax
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = tiny_cfg(Config, **cfg_updates)
    eng = GenerationEngine(cfg, device="cpu")
    eng.load_state_dicts(
        edm_state_dict_from_flax(params, depth=cfg.ar_model.overrides.depth),
        vae_state_dict_from_flax(vae_params, depth=cfg.lidar_ae.overrides.depth, query_type="mix"),
    )
    return eng


@contextlib.contextmanager
def jax_exact_chamfer():
    """rald_tpu's ``chamfer_and_fscore_batch`` on its TPU branch (the Pallas
    ``nn_min_sq_both`` kernel, exact subtract-square), in interpret mode."""
    import rald_tpu.eval.chamfer as jc
    import rald_tpu.ops.nn_dist_kernel as nk

    class _Tpu:
        def __getattr__(self, name):
            return (lambda: "tpu") if name == "default_backend" else getattr(jax, name)

    kernel, jc.jax = nk.nn_min_sq_both, _Tpu()
    nk.nn_min_sq_both = functools.partial(kernel, interpret=True)
    try:
        yield
    finally:
        nk.nn_min_sq_both, jc.jax = kernel, jax
