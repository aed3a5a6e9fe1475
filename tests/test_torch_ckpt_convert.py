"""The checkpoint converters, on the CPU at the tiny configs:

- ``scripts/orbax_to_pth.py``: a rald_tpu trainer checkpoint (orbax),
  written after one optimizer step of JAX's ``TrainState``, becomes a port
  trainer file that ``CheckpointManager.restore`` reads bitwise equal to
  ``train_state_from_flax`` of the same in-memory state (generation and
  ``ae`` kinds: params, EMA, Adam's moments and count, step, epoch);
  ``--params-only`` and a bare-``params`` radar autoencoder (as
  ``rald_tpu.cli.convert_ckpt --kind radar_enc`` writes it) become
  reference-layout ``.pth`` files, bitwise the weights;
- ``python -m rald_torch.cli.convert_ckpt``: a reference ``.pth`` becomes a
  resumable trainer file whose params and EMA are bitwise the file's,
  with a fresh optimizer and step 0; a missing or an unexpected key
  raises; one step resumed from it equals one step from a state loaded the
  same way; ``--kind radar_enc`` loads a whole autoencoder strictly."""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from torch_parity import TINY_CFG, draw_params

REPO = Path(__file__).resolve().parent.parent
RADAR_ENC = {"name": "ae_ch16_mult5_n2_d16", "overrides": {"embed_dim": 4}}
AE_CFG = {
    "system": {"seed": 0, "compute_dtype": "float32"},
    "dataset": {"lidar": {"pc_range": [0, -90, -20, 15.8, 90, 20], "voxel_size": [0.05, 0.25, 0.5],
                          "num_samples": 64, "query_ratio": 0.0625, "norm_isotropy": False,
                          "norm_anisotropy": True, "view_cone_mode": True}},
    "train": {"epochs": 2, "lr": 1e-3, "min_lr": 1e-6, "warmup_epochs": 0, "clip_grad": 10},
    "lidar_ae": {"name": "kl_d512_m512_l32_mix", "point_cloud_size": 64,
                 "overrides": dict(dim=64, queries_dim=64, depth=2, num_latents=16, latent_dim=8,
                                   heads=4, dim_head=16)},
    "eval": {"inference": {"num_query_points": 512}},
}


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_pth", REPO / "scripts" / "orbax_to_pth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _yaml(tmp_path, d, name="cfg.yml") -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(json.loads(json.dumps(d))))
    return str(path)


def _gen_dict(**train):
    d = json.loads(json.dumps(TINY_CFG))
    d["train"].update(train)
    d["radar_enc"] = RADAR_ENC
    return d


def _jax_state_after_step(cfg_path, kind):
    """rald_tpu's engine and its train state after one optimizer step on
    numpy gradients (Adam's moments and count, the EMA all moved)."""
    from rald_tpu.config import load_config

    mod = _script()
    jeng = mod._jax_engine(load_config(cfg_path), kind)
    abstract = jax.eval_shape(lambda: jeng.init_state(1, 1))  # init_state's tree, not run
    rng = np.random.default_rng(3)
    params = draw_params(abstract.params, rng)
    state = abstract.replace(params=params, ema_params=jax.tree_util.tree_map(np.copy, params),
                             opt_state=abstract.tx.init(params), step=np.zeros((), np.int32))
    grads = jax.tree_util.tree_map(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(a.dtype),
                                   state.params)
    return jeng, jax.jit(lambda s, g: s.apply_gradients(g, 0.999))(state, grads)


def _port_engine(cfg_path, kind):
    from rald_torch.config import load_config

    if kind == "generation":
        from rald_torch.train.gen_engine import GenerationEngine as Engine
    else:
        from rald_torch.train.ae_engine import AEEngine as Engine
    return Engine(load_config(cfg_path), device="cpu")


def _assert_states_equal(a, b):
    assert sorted(a.params) == sorted(b.params)
    oa, ob = a.opt_state(), b.opt_state()
    for k in a.params:
        for x, y in ((a.params[k], b.params[k]), (a.ema_params[k], b.ema_params[k]),
                     (oa["mu"][k], ob["mu"][k]), (oa["nu"][k], ob["nu"][k])):
            assert torch.equal(x, y), k
    assert (a.step, a.count, oa["count"]) == (b.step, b.count, ob["count"])


@pytest.mark.parametrize("kind", ["generation", "ae"])
def test_orbax_trainer_checkpoint_restores_bitwise(tmp_path, kind):
    from rald_torch.convert.flax_params import train_state_from_flax
    from rald_torch.train.checkpoint import CheckpointManager as PortManager
    from rald_tpu.train.checkpoint import CheckpointManager

    cfg_path = _yaml(tmp_path, _gen_dict() if kind == "generation" else AE_CFG)
    jeng, state = _jax_state_after_step(cfg_path, kind)
    src = CheckpointManager(tmp_path / "jax").save(state, 3)
    mod = _script()
    lines = []
    path = mod.run(cfg_path, kind, str(src), str(tmp_path / "port"), print_fn=lines.append)
    assert path == (tmp_path / "port" / "checkpoint-3.pth").resolve()
    assert lines == [f"converted {src} -> {path}"]
    got, epoch = PortManager(tmp_path / "port").restore(_port_engine(cfg_path, kind).init_state(1, 1),
                                                        path)
    st = jax.device_get(state)
    want = train_state_from_flax(_port_engine(cfg_path, kind).init_state(1, 1), st.params,
                                 st.ema_params, st.opt_state, st.step,
                                 convert=mod._converter(jeng, kind))
    assert epoch == 3 and got.step == 1 and got.count == 1
    _assert_states_equal(got, want)
    assert any(not torch.equal(got.params[k], got.ema_params[k]) for k in got.params)

    # --params-only: the reference layout of the params (train.use_ema unset)
    only = mod.run(cfg_path, kind, str(src), str(tmp_path / "only"), params_only=True,
                   print_fn=lines.append)
    sd = torch.load(only, map_location="cpu", weights_only=True)["model"]
    assert sorted(sd) == sorted(want.params)
    assert all(torch.equal(sd[k], want.params[k]) for k in sd)


def test_orbax_params_only_follows_use_ema(tmp_path):
    from rald_tpu.train.checkpoint import CheckpointManager

    cfg_path = _yaml(tmp_path, _gen_dict(use_ema=True))
    _, state = _jax_state_after_step(cfg_path, "generation")
    src = CheckpointManager(tmp_path / "jax").save(state, 0)
    mod = _script()
    sd = torch.load(mod.run(cfg_path, "generation", str(src), str(tmp_path / "o"), params_only=True,
                            print_fn=lambda *_: None), weights_only=True)["model"]
    w = np.asarray(jax.device_get(state.ema_params["model"]["proj_in"]["kernel"])).T
    np.testing.assert_array_equal(sd["model.proj_in.weight"].numpy(), w)


def test_orbax_bare_radar_autoencoder(tmp_path):
    """A radar autoencoder .pth -> a bare ``params`` orbax tree, as
    ``rald_tpu.cli.convert_ckpt --kind radar_enc`` writes it (its converter,
    saved here and waited for) -> this script -> the same state_dict,
    bitwise; the port's radar_enc converter then takes it."""
    import orbax.checkpoint as ocp

    from rald_torch.cli import convert_ckpt as cc
    from rald_torch.models.registry import get_radar_encoder_model
    from rald_torch.train.checkpoint import load_torch_checkpoint, save_torch_checkpoint
    from rald_torch.train.gen_engine import init_random_weights
    from rald_tpu.convert.torch_ckpt import convert_radar_autoencoder_state_dict

    d = _gen_dict()
    d["ar_model"]["configs"]["unfreeze_radar_enc"] = False
    cfg_path = _yaml(tmp_path, d)
    ae = get_radar_encoder_model(RADAR_ENC["name"], in_channels=1, overrides=RADAR_ENC["overrides"])
    init_random_weights(ae, torch.Generator().manual_seed(2))
    ref = save_torch_checkpoint(tmp_path / "radar_ae.pth", ae.state_dict())
    src = (tmp_path / "jax" / "checkpoint-2").resolve()
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(src, {"params": convert_radar_autoencoder_state_dict(
        {k: v.numpy() for k, v in load_torch_checkpoint(ref).items()})})
    ckptr.wait_until_finished()
    out = _script().run(cfg_path, "radar_enc", str(src), str(tmp_path / "port"),
                        print_fn=lambda *_: None)
    assert out.name == "checkpoint-0.pth"  # a bare tree holds no epoch
    got, want = load_torch_checkpoint(out), ae.state_dict()
    assert sorted(got) == sorted(want) and any(k.startswith("decoder.") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)
    again = cc.run(_load(cfg_path), "radar_enc", str(out), str(tmp_path / "again"),
                   print_fn=lambda *_: None)
    assert all(torch.equal(load_torch_checkpoint(again)[k], want[k]) for k in want)


def _load(cfg_path):
    from rald_torch.config import load_config

    return load_config(cfg_path)


def _reference_pth(tmp_path, cfg_path, kind):
    """A reference-layout .pth of random weights for the YAML's model."""
    from rald_torch.train.checkpoint import save_torch_checkpoint
    from rald_torch.train.gen_engine import init_random_weights

    eng = _port_engine(cfg_path, kind)
    model = eng.model if kind == "generation" else eng.train_model_factory()
    init_random_weights(model, torch.Generator().manual_seed(9))
    sd = {k: v.float() for k, v in model.state_dict().items()}
    return save_torch_checkpoint(tmp_path / f"{kind}.pth", sd), sd


@pytest.mark.parametrize("kind", ["generation", "ae"])
def test_convert_ckpt_writes_a_fresh_trainer_file(tmp_path, kind):
    from rald_torch.cli import convert_ckpt as cc
    from rald_torch.train.checkpoint import CheckpointManager

    cfg_path = _yaml(tmp_path, _gen_dict() if kind == "generation" else AE_CFG)
    state = _port_engine(cfg_path, kind).init_state(1, 1)
    sd = {k: (torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k)))).float()
          for k, v in state.params.items()}
    ref = tmp_path / "ref.pth"
    torch.save({"model": sd}, ref)
    path = cc.main(["--config", cfg_path, "--kind", kind, "--torch-ckpt", str(ref), "--out",
                    str(tmp_path / "out"), "--epoch", "4", "--device", "cpu"])
    assert path == (tmp_path / "out" / "checkpoint-4.pth").resolve()
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert raw["step"] == 0 and raw["epoch"] == 4 and raw["optimizer"]["count"] == 0
    for k, v in sd.items():
        assert torch.equal(raw["model"][k], v) and torch.equal(raw["model_ema"][k], v)
        assert not raw["optimizer"]["mu"][k].any() and not raw["optimizer"]["nu"][k].any()
    fresh = _port_engine(cfg_path, kind).init_state(1, 1)
    _, epoch = CheckpointManager(tmp_path / "out").restore(fresh, path)
    assert epoch == 4 and all(torch.equal(fresh.params[k], sd[k]) for k in sd)


def test_convert_ckpt_refuses_mismatched_keys(tmp_path):
    from rald_torch.cli import convert_ckpt as cc

    cfg_path = _yaml(tmp_path, _gen_dict())
    state = _port_engine(cfg_path, "generation").init_state(1, 1)
    sd = {k: v.clone() for k, v in state.params.items()}
    gone = sd.pop("model.proj_in.weight")
    torch.save({"model": sd}, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match=r"missing from checkpoint: \['model.proj_in.weight'\]"):
        cc.run(_load(cfg_path), "generation", str(tmp_path / "missing.pth"), str(tmp_path / "o"),
               device="cpu")
    torch.save({"model": {**sd, "model.proj_in.weight": gone, "model.extra": gone}},
               tmp_path / "extra.pth")
    with pytest.raises(ValueError, match=r"unexpected in checkpoint: \['model.extra'\]"):
        cc.run(_load(cfg_path), "generation", str(tmp_path / "extra.pth"), str(tmp_path / "o"),
               device="cpu")
    torch.save({"weights": {**sd, "model.proj_in.weight": gone}}, tmp_path / "key.pth")
    cc.run(_load(cfg_path), "generation", str(tmp_path / "key.pth"), str(tmp_path / "o"),
           state_key="weights", device="cpu", print_fn=lambda *_: None)


def test_resumed_step_equals_a_step_from_the_same_weights(tmp_path):
    from rald_torch.cli import convert_ckpt as cc
    from rald_torch.train.checkpoint import CheckpointManager

    cfg_path = _yaml(tmp_path, _gen_dict())
    eng = _port_engine(cfg_path, "generation")
    state = eng.init_state(1, 1)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
          for k, v in state.params.items()}
    torch.save({"model": sd}, tmp_path / "ref.pth")
    path = cc.run(_load(cfg_path), "generation", str(tmp_path / "ref.pth"), str(tmp_path / "o"),
                  device="cpu", print_fn=lambda *_: None)
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    cube = torch.from_numpy(rng.standard_normal((2, 32, 16, 16, 3)).astype(np.float32))
    rnd = torch.from_numpy(rng.standard_normal((2, 1, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    out = []
    for load in ("resume", "direct"):
        st = eng.init_state(1, 1)
        if load == "resume":
            CheckpointManager(tmp_path / "o").restore(st, path)
        else:
            st.load(sd, sd, st.opt_state(), 0)
        st, m = eng.train_step(st, latents, cube, rnd=rnd, noise=noise)
        out.append((st, m))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"]) and a.step == b.step == 1
    _assert_states_equal(a, b)
