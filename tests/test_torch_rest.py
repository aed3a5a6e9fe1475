"""The last modules of rald_tpu that the port lacked, against rald_tpu:

- the radar autoencoder: ``RadarAutoencoder.forward`` (encoder, the mirror
  ``RadarDecoder3D`` with its ``Upsample3D``) against JAX's ``__call__`` at
  a tiny config, f32, 1e-5 of max|out|; a whole reference state_dict
  (``encoder.*`` and ``decoder.*``) round-trips through rald_tpu's
  ``convert_radar_autoencoder_state_dict`` and loads strictly;
- ``create_autoencoder``: the model JAX's factory builds loads, strictly,
  into the port's;
- ``streaming_single_head_attention`` against JAX's across chunk
  boundaries with a ragged last chunk;
- the profiler hooks: ``maybe_trace`` writes a Chrome trace naming an
  ``annotate`` region, and is a no-op without a profile dir;
- each ported function keeps JAX's parameter names."""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import draw_params

TINY_RADAR = dict(basic_channel=8, ch_mult=(1, 2), num_res_blocks=1, embed_dim=4, in_channels=2)


@pytest.fixture(autouse=True)
def _highest_precision():
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield


def _jax_radar_ae(seed=0):
    from rald_tpu.models.radar_encoder3d import create_radar_autoencoder

    model = create_radar_autoencoder(**TINY_RADAR)
    x = np.random.default_rng(seed).normal(size=(2, 16, 8, 8, 2)).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = draw_params(shapes, np.random.default_rng(seed + 1))
    return model, params, x


def test_radar_autoencoder_forward_matches_jax():
    from rald_torch.convert.flax_params import radar_autoencoder_state_dict_from_flax
    from rald_torch.models.radar_encoder3d import create_radar_autoencoder

    jmodel, params, x = _jax_radar_ae()
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params, jnp.asarray(x))
    port = create_radar_autoencoder(**TINY_RADAR).eval()
    port.load_state_dict(radar_autoencoder_state_dict_from_flax(params))  # strictly
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert sorted(got) == ["latent", "pred"]
    for k, shape in (("latent", (2, 8, 4, 4, 4)), ("pred", (2, 16, 8, 8, 2))):
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape == shape
        assert np.abs(got[k].numpy() - w).max() <= 1e-5 * np.abs(w).max(), k
    with torch.no_grad():
        torch.testing.assert_close(port.decode(port.encode(torch.from_numpy(x))), got["pred"],
                                   rtol=0, atol=0)


def test_upsample_is_jax_nearest():
    from rald_torch.models.radar_encoder3d import Upsample3D

    x = np.random.default_rng(2).normal(size=(1, 3, 5, 2, 4)).astype(np.float32)  # NDHWC
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 6, 10, 4, 4), method="nearest"))
    up = Upsample3D(4)
    got = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                          scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)
    assert tuple(up(torch.zeros(1, 4, 3, 5, 2)).shape) == (1, 4, 6, 10, 4)


def test_radar_autoencoder_state_dict_round_trip():
    """A port autoencoder's whole state_dict is the reference layout:
    rald_tpu's converter reads it into JAX's parameter tree, and the port's
    converter gives it back bitwise."""
    from rald_torch.convert.flax_params import radar_autoencoder_state_dict_from_flax
    from rald_torch.models.radar_encoder3d import RadarAutoencoder, create_radar_autoencoder
    from rald_torch.train.checkpoint import split_radar_autoencoder
    from rald_torch.train.gen_engine import init_random_weights
    from rald_tpu.convert.torch_ckpt import convert_radar_autoencoder_state_dict

    jmodel, params, _ = _jax_radar_ae()
    port = create_radar_autoencoder(**TINY_RADAR)
    init_random_weights(port, torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = convert_radar_autoencoder_state_dict(sd, num_levels=2, num_res_blocks=1)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    back = radar_autoencoder_state_dict_from_flax(tree)
    assert sorted(back) == sorted(sd)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)
    assert any(k.startswith("decoder.up.1.upsample.conv") for k in sd)
    enc, dec = split_radar_autoencoder(port.state_dict())
    RadarAutoencoder(**TINY_RADAR, decoder=False).load_state_dict(enc)  # strictly: the frozen encoder's half
    assert dec and all(k.startswith("decoder.") for k in dec)
    with pytest.raises(KeyError, match="unexpected radar decoder param"):
        radar_autoencoder_state_dict_from_flax({"encoder": params["encoder"],
                                                "decoder": {"up_9_extra": {}}})


def test_create_autoencoder_builds_jax_model():
    from rald_torch.convert.flax_params import vae_state_dict_from_flax
    from rald_torch.models.vecset_vae import create_autoencoder
    from rald_tpu.models.vecset_vae import create_autoencoder as jax_create

    kw = dict(dim=64, M=16, latent_dim=8, N=64, query_type="mix")
    jm = jax_create(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)),
                            jnp.zeros((1, 8, 3)))["params"]
    params = draw_params(shapes, np.random.default_rng(0))
    port = create_autoencoder(**kw)
    assert (len(port.layers), port.num_latents, port.latent_dim) == (24, 16, 8)
    port.load_state_dict(vae_state_dict_from_flax(params, depth=24, query_type="mix"))
    assert create_autoencoder().query_type == "point"


@pytest.mark.parametrize("q_len,chunk", [(1000, 384), (300, 512), (1024, 256)])
def test_streaming_attention_matches_jax(q_len, chunk):
    from rald_torch.ops import KERNELS, streaming_single_head_attention
    from rald_tpu.ops import streaming_single_head_attention as jax_attn

    rng = np.random.default_rng(q_len)
    q, k, v = (rng.normal(size=(2, n, 16)).astype(np.float32) for n in (q_len, 7, 7))
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_size=chunk))
    got = streaming_single_head_attention(*map(torch.from_numpy, (q, k, v)), chunk_size=chunk)
    assert got.shape == want.shape == (2, q_len, 16)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    scaled = streaming_single_head_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3,
                                             chunk_size=chunk)
    want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
                               chunk_size=chunk))
    assert np.abs(scaled.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert "streaming_single_head_attention" not in KERNELS


def test_maybe_trace_writes_annotated_trace(tmp_path, monkeypatch):
    from rald_torch.config import Config
    from rald_torch.train.profiler import annotate, maybe_trace, profile_dir_from

    monkeypatch.delenv("RALD_PROFILE_DIR", raising=False)
    cfg = Config({"system": {"profile_dir": str(tmp_path / "cfg")}})
    assert profile_dir_from(cfg) == str(tmp_path / "cfg") and profile_dir_from() is None
    with maybe_trace(profile_dir=str(tmp_path / "t")) as prof:
        with annotate("rald_probe_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "rald_probe_region" for e in events)
    monkeypatch.setenv("RALD_PROFILE_DIR", str(tmp_path / "env"))
    assert profile_dir_from(cfg) == str(tmp_path / "env")
    with maybe_trace(cfg):
        pass
    assert len(list((tmp_path / "env").glob("trace_*.json"))) == 1


def test_maybe_trace_without_dir_is_a_no_op(tmp_path, monkeypatch):
    from rald_torch.train.profiler import maybe_trace

    monkeypatch.delenv("RALD_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_trace() as prof:
        torch.ones(3).sum()
    assert prof is None and list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("port,ref", [
    ("rald_torch.ops.query_attention:streaming_single_head_attention",
     "rald_tpu.ops.query_attention:streaming_single_head_attention"),
    ("rald_torch.models.vecset_vae:create_autoencoder", "rald_tpu.models.vecset_vae:create_autoencoder"),
    ("rald_torch.models.radar_encoder3d:create_radar_autoencoder",
     "rald_tpu.models.radar_encoder3d:create_radar_autoencoder"),
    ("rald_torch.train.profiler:profile_dir_from", "rald_tpu.train.profiler:profile_dir_from"),
    ("rald_torch.train.profiler:maybe_trace", "rald_tpu.train.profiler:maybe_trace"),
    ("rald_torch.train.profiler:annotate", "rald_tpu.train.profiler:annotate"),
])
def test_ported_signature_is_jax(port, ref):
    import importlib

    def params(path):
        mod, name = path.split(":")
        return list(inspect.signature(getattr(importlib.import_module(mod), name)).parameters)

    assert params(port) == params(ref)
