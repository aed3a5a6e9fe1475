"""``system.matmul_precision`` in the port: ``rald_torch.apply_matmul_precision``
maps each value JAX's ``jax_default_matmul_precision`` takes onto both torch
switches (``torch.set_float32_matmul_precision`` and
``torch.backends.cudnn.allow_tf32``), and ``rald_torch.cli.infer.run``
applies the YAML's value before it runs, as JAX's CLI does."""
import numpy as np
import pytest
import torch

from rald_torch.config import Config
from torch_parity import tiny_cfg

# value -> (torch float32 matmul precision, cuDNN TF32)
MAPPING = {
    "highest": ("highest", False), "float32": ("highest", False),
    "high": ("high", True), "tensorfloat32": ("high", True), "bfloat16_3x": ("high", True),
    "default": ("medium", True), "bfloat16": ("medium", True), "fastest": ("medium", True),
}


@pytest.fixture(autouse=True)
def _restore_switches():
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny CPU engine and one preprocessed cube, shared by the CLI runs."""
    from rald_torch.train.gen_engine import GenerationEngine

    root = tmp_path_factory.mktemp("precision")
    (root / "in").mkdir()
    np.save(root / "in" / "0000.npy",
            np.random.default_rng(0).normal(size=(32, 16, 16, 2)).astype(np.float32))
    cfg = tiny_cfg(Config)
    cfg.eval.inference.num_query_points = 256
    return GenerationEngine(cfg, device="cpu"), root


def _set_opposite(want):
    """Set both switches away from ``want`` so that a run that leaves them
    alone fails."""
    torch.set_float32_matmul_precision("medium" if want[0] == "highest" else "highest")
    torch.backends.cudnn.allow_tf32 = not want[1]


@pytest.mark.parametrize("value", sorted(MAPPING))
def test_apply_matmul_precision_sets_both_switches(value):
    from rald_torch import apply_matmul_precision

    want = MAPPING[value]
    _set_opposite(want)
    assert apply_matmul_precision(value) == want[0]
    assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == want


@pytest.mark.parametrize("value", sorted(MAPPING))
def test_cli_run_follows_yaml_matmul_precision(cli_setup, value):
    from rald_torch.cli import infer

    eng, root = cli_setup
    cfg = tiny_cfg(Config, system={"matmul_precision": value})
    want = MAPPING[value]
    _set_opposite(want)
    stats = infer.run(cfg, str(root / "in"), str(root / f"out_{value}"), batch=1,
                      preprocessed=True, engine=eng, print_fn=lambda *_: None)
    assert stats["files"] == 1
    assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == want


def test_cli_run_without_the_key_leaves_the_switches(cli_setup):
    from rald_torch.cli import infer

    eng, root = cli_setup
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = False
    infer.run(tiny_cfg(Config), str(root / "in"), str(root / "out_none"), batch=1,
              preprocessed=True, engine=eng, print_fn=lambda *_: None)
    assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == (
        "high", False)


def test_unknown_matmul_precision_raises(cli_setup):
    from rald_torch import apply_matmul_precision
    from rald_torch.cli import infer

    eng, root = cli_setup
    with pytest.raises(ValueError, match="matmul_precision"):
        apply_matmul_precision("tf32x")
    cfg = tiny_cfg(Config, system={"matmul_precision": "bf16_6x"})
    with pytest.raises(ValueError, match="matmul_precision"):
        infer.run(cfg, str(root / "in"), str(root / "out_bad"), batch=1, preprocessed=True,
                  engine=eng, print_fn=lambda *_: None)
