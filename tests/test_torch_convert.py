"""The weights bridge and the port's independence from JAX.

- Round trip: a port ``state_dict`` -> rald_tpu's torch->flax converter ->
  rald_torch's flax->torch function gives back the same ``state_dict``,
  exactly, for the DiT (with its radar encoder), the VAE (encoder keys
  included) and the radar encoder alone.
- ``import rald_torch`` pulls in neither JAX nor rald_tpu nor triton, and
  builds nothing; no module under ``rald_torch/`` imports them.
- Entry points run on the card unless the caller asks for the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference side of the suite; keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from rald_torch.convert import flax_params as fp
from rald_tpu.convert import torch_ckpt

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rald_torch"


def _np_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _random(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    from rald_torch.train.gen_engine import init_random_weights

    init_random_weights(module, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # distinct norm scales/biases too, so a swap shows
        for name, p in module.named_parameters():
            if name.endswith(("norm1.weight", "norm.weight", "bias")):
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    return module


def test_edm_round_trip():
    from rald_torch.models.registry import get_generation_model

    configs = {"cond_type": "radar", "use_radar_enc": True, "unfreeze_radar_enc": True,
               "radar_token_channel": 32, "enc_radar_r_dim": 2, "enc_radar_a_dim": 1,
               "enc_radar_e_dim": 1, "enc_radar_ch": 4, "enc_hidden_ch": 8}
    model = _random(get_generation_model("kl_d512_m512_l32_d24_edm", configs,
                                         {"n_latents": 16, "channels": 8, "depth": 3,
                                          "n_heads": 2, "d_head": 16}), 0)
    sd = _np_sd(model)
    assert "model.transformer_blocks.2.ff.net.0.proj.weight" in sd
    assert "model.transformer_blocks.0.attn1.to_out.0.weight" in sd
    assert "radar_enc.down.4.block.1.conv2.weight" in sd
    back = fp.edm_state_dict_from_flax(torch_ckpt.convert_edm_state_dict(sd, depth=3), depth=3)
    _assert_same(back, sd)


@pytest.mark.parametrize("query_type", ["mix", "learnable", "point"])
def test_vae_round_trip_with_encoder_keys(query_type):
    from rald_torch.models.vecset_vae import VecSetVAE

    vae = _random(VecSetVAE(depth=2, dim=64, queries_dim=64, num_latents=16, latent_dim=8,
                            heads=4, dim_head=16, query_type=query_type), 1)
    sd = _np_sd(vae)
    assert "layers.1.1.fn.net.0.weight" in sd and "cross_attend_blocks.1.fn.net.2.weight" in sd
    params = torch_ckpt.convert_vae_state_dict(sd, depth=2, query_type=query_type)
    _assert_same(fp.vae_state_dict_from_flax(params, depth=2, query_type=query_type), sd)


def test_radar_encoder_round_trip():
    from rald_torch.models.radar_encoder3d import RadarEncoder3D

    enc = _random(RadarEncoder3D(ch=8, z_channels=4), 2)
    sd = _np_sd(enc)
    assert "down.3.downsample.conv.weight" in sd and "down.4.attn.1.q.weight" in sd
    params = torch_ckpt.convert_radar_encoder_state_dict(sd)
    _assert_same(fp.radar_encoder_state_dict_from_flax(params), sd)


def test_unknown_radar_param_is_refused():
    with pytest.raises(KeyError, match="unexpected"):
        fp.radar_encoder_state_dict_from_flax({"up_0_block_0": {}})


def test_import_pulls_in_no_jax_no_reference_no_triton(tmp_path):
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts[: -1 if p.name == "__init__.py" else None])
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys\n"
        "import rald_torch, rald_torch.train.gen_engine\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'rald_tpu', 'triton')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(modules) >= 15 and "rald_torch.native" in modules


def test_import_builds_nothing():
    from rald_torch import native
    from rald_torch.ops import _build

    dirs = (_build.BUILD_DIR, native.BUILD_DIR)
    assert all(d.parent.parent == REPO for d in dirs)

    def built():
        return [sorted(d.glob("*.so")) if d.exists() else [] for d in dirs]

    before = built()
    subprocess.run([sys.executable, "-c", "import rald_torch.ops, rald_torch.train.gen_engine, "
                    "rald_torch.native, rald_torch.data.coloradar"],
                   cwd=REPO, check=True, timeout=120)
    assert built() == before


def test_source_scan_has_no_jax_or_reference_imports():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|rald_tpu)\b", re.M)
    hits = [f"{p}:{m.group(0).strip()}" for p in PORT.rglob("*.py") for m in pat.finditer(p.read_text())]
    assert hits == []
    assert not re.search(r"^\s*(from|import)\s+triton\b", "\n".join(
        p.read_text() for p in PORT.rglob("*.py")), re.M)


def test_entry_point_without_card_raises(monkeypatch):
    from rald_torch import resolve_device
    from rald_torch.config import Config
    from rald_torch.eval.chamfer import chamfer_and_fscore_batch
    from rald_torch.train.gen_engine import GenerationEngine
    from torch_parity import tiny_cfg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(tiny_cfg(Config))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chamfer_and_fscore_batch([np.zeros((1, 3))], [np.zeros((1, 3))], 0.1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert GenerationEngine(tiny_cfg(Config), device="cpu").device.type == "cpu"


def test_product_yaml_reads_the_same():
    from rald_torch.config import load_config as t_load
    from rald_tpu.config import load_config as j_load

    path = REPO / "configs" / "generation" / "ge_indoor_unfreeze_enc_ints_only_eval.yml"
    assert t_load(path).to_dict() == j_load(path).to_dict()


def test_kernel_build_failure_waits_and_cleans_up(tmp_path, monkeypatch):
    """A failing nvcc raises with its log, after every started nvcc has
    ended, and leaves no partial library behind."""
    from rald_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="fake compiler"):
        _build.build_all()
    assert list((tmp_path / "kernels").iterdir()) == []
