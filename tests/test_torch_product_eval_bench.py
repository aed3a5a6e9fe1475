"""``python -m rald_torch.cli.product_eval_bench`` (the port of
``scripts/product_eval_bench.py``) on the CPU.

- The recipe: every ``cfg.*`` key JAX's script sets (``:61-84``), its
  ``eval.inference`` block and its ``RALD_BENCH_INT8`` branches (``:85-93``),
  read from the script's source with ``ast`` (running it would write into
  JAX's ``docs/artifacts/``), against the port's recipe on the same
  ``gen.yml`` (:func:`rald_torch.cli.precision_gate.recipe_cfg`, shared
  with the precision gate) and its int8 mapping; a bad value raises; the
  artifact names are JAX's, under ``docs/artifacts/h100/``.
- ``run`` at tiny width (the JAX test harness's generation config over a
  3-frame split in batches of 2, JAX's recipe switches at tiny counts, the
  helpers densified on the device): the frames are the 3 real frames, not
  the 4 of the padded batches; the artifact has JAX's keys (less
  ``compiled_programs``, now ``kernel_launches``) and the torch settings in
  force; IoU / CD / F are identical across the timed passes.
- Its metrics against ``rald_tpu``'s ``evaluate`` on the same tree, config
  and weights (JAX's per-seed prior draw injected). The tolerances are
  ``tests/test_torch_evaluate.py``'s for this path: loss and IoU draw
  nothing and agree within 1e-5 (well inside the precision gate's
  |ΔIoU| <= 0.005 bar); CD and F come from each package's own device
  stream (the helper densify and the refine jitter), so they agree as two
  draws of one distribution, CD within 5 % and F within 10 % (+ 0.01).
- Without a card and without ``--device cpu`` / ``RALD_BENCH_CPU=1`` it
  raises."""
import ast
import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_precision_gate import _cfgs, _jax_prior, tree, weights  # noqa: F401 (fixtures)
from torch_parity import jax_exact_chamfer

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "product_eval_bench.py"


@pytest.fixture(autouse=True)
def _restore_precision():
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]


def _path(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    assert isinstance(node, ast.Name) and node.id == "cfg"
    return ".".join(reversed(parts))


def _value(node):
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "Config":
        return ast.literal_eval(node.args[0])
    if isinstance(node, ast.Compare):  # os.environ.get("RALD_PE_HOST_HELPER") != "1"
        return ("env !=", node.left.args[0].value, node.comparators[0].value)
    if isinstance(node, ast.Call):  # str(ckpt)
        return ("call", node.func.id)
    return ast.literal_eval(node)


def _assigns(body) -> dict:
    return {_path(s.targets[0]): _value(s.value) for s in body
            if isinstance(s, ast.Assign) and isinstance(s.targets[0], ast.Attribute)}


def _jax_recipe() -> tuple:
    """JAX's ``main``: the recipe's assignments and ``{RALD_BENCH_INT8
    value: eval.inference flags}`` from its if / elif chain."""
    main = next(n for n in ast.parse(JAX_SCRIPT.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    recipe = _assigns(main.body)
    branches, node = {}, next(s for s in main.body if isinstance(s, ast.If)
                              and "int8_env" in ast.unparse(s.test))
    while isinstance(node, ast.If):
        flags = {k.rsplit(".", 1)[1]: v for k, v in _assigns(node.body).items()}
        if flags:
            test = node.test
            values = ast.literal_eval(test.comparators[0])
            for v in values if isinstance(values, tuple) else (values,):
                branches[v] = flags
        node = node.orelse[0] if node.orelse else None
    return recipe, branches


def _gen_yml(root: Path) -> Path:
    from rald_torch.cli.curves_configs import recipe_configs

    root.mkdir(parents=True, exist_ok=True)
    (root / "gen.yml").write_text(yaml.safe_dump(recipe_configs(root)[1].to_dict()))
    return root


def test_recipe_and_int8_modes_match_jaxs_script(tmp_path):
    from rald_torch.cli import product_eval_bench as peb
    from rald_torch.cli.precision_gate import recipe_cfg

    recipe, branches = _jax_recipe()
    assert {"system.mode", "eval.ckpt", "dataset.helper_aug_on_device", "eval.inference",
            "eval.use_test_set"} <= set(recipe)
    root = _gen_yml(tmp_path)
    ckpt = root / "out_gen" / "checkpoint-479.pth"
    for host_helper in (False, True):
        cfg = recipe_cfg(root, ckpt, helper_aug_on_device=not host_helper)
        for key, want in recipe.items():
            got = cfg
            for part in key.split("."):
                got = got[part]
            if key == "eval.ckpt":
                assert want == ("call", "str") and got == str(ckpt)
            elif key == "dataset.helper_aug_on_device":
                assert want == ("env !=", "RALD_PE_HOST_HELPER", "1")
                assert got is (not host_helper)
            elif key == "eval.inference":
                assert got.to_dict() == want
            else:
                assert got == want, key
    assert set(branches) == {"1", "dynamic", "static"}
    for value, flags in branches.items():
        assert peb.int8_mode(value)[0] == flags, value
    assert peb.int8_mode("") == ({}, "bf16")
    with pytest.raises(ValueError, match="RALD_BENCH_INT8 must be"):
        peb.int8_mode("int4")
    with pytest.raises(ValueError, match="RALD_BENCH_INT8 must be"):
        peb.run(root, ckpt, device="cpu", int8="fp8")
    # JAX's artifact names, in the port's folder
    names = {(i, a): peb.default_out(i, a) for i in ("", "dynamic", "static") for a in (0, 1)}
    assert {p.parent for p in names.values()} == {REPO / "docs" / "artifacts" / "h100"}
    assert names[("", 0)].name == "product_eval_bench.json"
    assert names[("dynamic", 0)].name == "product_eval_bench_int8_dynamic.json"
    assert names[("static", 0)].name == "product_eval_bench_int8_static.json"
    assert names[("static", 1)].name == "product_eval_attrib.json"


def test_no_card_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    from rald_torch.cli import product_eval_bench as peb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RALD_BENCH_CPU", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peb.run(tmp_path, tmp_path / "missing.pth")
    monkeypatch.setenv("RALD_BENCH_CPU", "1")  # on the CPU: the checkpoint is looked for
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        peb.run(tmp_path, tmp_path / "missing.pth")


def _bench_cfg(root, tmp_path):
    """The gate test's tiny recipe (``_cfgs``) with the bench's switch: the
    helpers densified on the device."""
    jcfg, tcfg = _cfgs(root)
    for c in (jcfg, tcfg):
        c.dataset.helper_aug_on_device = True
        c.system.output_dir = str(tmp_path / "out")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bench(tree, weights, tmp_path_factory):  # noqa: F811
    """The port's bench (a warm-up and 2 timed passes) and JAX's
    ``evaluate`` on the same recipe, tree and weights."""
    from rald_torch.cli import product_eval_bench as peb
    from rald_torch.cli.main_generation import build_eval_loader
    from rald_tpu.cli.main_generation import build_loaders
    from rald_tpu.train.gen_engine import GenerationEngine
    from rald_torch.train import gen_engine as tge
    from rald_torch.train.checkpoint import save_torch_checkpoint

    d = tmp_path_factory.mktemp("bench")
    params, vp, edm_sd, vae_sd = weights
    jcfg, tcfg = _bench_cfg(tree, d)
    ckpt = save_torch_checkpoint(d / "out_gen" / "checkpoint-1.pth", edm_sd)
    tcfg.lidar_ae.ckpt = str(save_torch_checkpoint(d / "vae.pth", vae_sd))
    tcfg.eval.ckpt = str(ckpt)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = False
    mp = pytest.MonkeyPatch()
    mp.setattr(tge, "sample_prior_latents", _jax_prior)  # the engine's draw_prior
    try:
        art = peb.run(d, ckpt, repeats=2, out=d / "bench.json", device="cpu",
                      cfg=copy.deepcopy(tcfg), print_fn=lambda *_: None)
    finally:
        mp.undo()
    in_force = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
                "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.set_float32_matmul_precision("highest")
    loader = build_eval_loader(tcfg, "eval", print_fn=lambda *_: None)
    jeng = GenerationEngine(jcfg)
    jeng._chamfer_pallas = True  # exact subtract-square Chamfer (torch_parity.jax_exact_chamfer)
    _, jloader, _ = build_loaders(jcfg, {"world_size": 1, "rank": 0}, "eval")
    with jax_exact_chamfer():
        want = jeng.evaluate(params, jloader, vp, None, print_fn=lambda *_: None)
    return d, art, in_force, loader, want


def test_frames_count_real_frames_not_pad_last(bench):
    from rald_torch.cli.product_eval_bench import real_frames

    _, art, _, loader, _ = bench
    assert len(loader) == 2 and loader.batch_size == 2 and loader.pad_last  # 4 rows, 3 frames
    assert real_frames(loader) == 3 and real_frames(loader, 1) == 2
    assert art["summary"]["frames"] == 3 and art["summary"]["batches_per_pass"] == 2
    assert all(p["frames"] == 3 for p in [art["passes"]["warmup"], *art["passes"]["timed"]])


def test_artifact_keys_precision_and_identical_passes(bench):
    d, art, in_force, _, _ = bench
    assert json.loads((d / "bench.json").read_text()) == art
    jax_art = json.loads((REPO / "docs" / "artifacts" / "product_eval_bench.json").read_text())
    assert set(jax_art) - {"compiled_programs"} <= set(art)
    assert {"kernel_launches", "summary", "device"} <= set(art)
    assert set(art["passes"]) == set(jax_art["passes"]) == {"warmup", "timed"}
    assert len(art["passes"]["timed"]) == 2
    for row in [art["passes"]["warmup"], *art["passes"]["timed"]]:
        assert set(row) == set(jax_art["passes"]["timed"])
    assert art["backend"] == "cpu" and art["device"] == "cpu"
    assert art["inference_mode"] == "bf16" and art["eval_batch_size"] == 2
    assert art["helper_aug_on_device"] is True
    assert art["matmul_precision"]["float32_matmul_precision"] == "high"
    assert art["matmul_precision"]["cudnn_allow_tf32"] is False
    assert {k: art["matmul_precision"][k] for k in in_force} == in_force
    assert art["kernel_launches"]["per_batch"] == {}  # the CPU runs the plain versions
    s = art["summary"]
    assert s["metrics_identical"] and s["timed_passes"] == 2
    assert s["pc_per_sec"]["min"] <= s["pc_per_sec"]["median"] <= s["pc_per_sec"]["max"]
    a, b = art["passes"]["timed"]
    assert (a["iou"], a["cd_m"], a["fscore"]) == (b["iou"], b["cd_m"], b["fscore"])


def test_metrics_match_jax_evaluate(bench):
    _, art, _, _, want = bench
    got = art["passes"]["timed"][0]
    np.testing.assert_allclose(got["iou"], want["iou"], atol=1e-5, rtol=1e-5)
    assert 0.05 < got["iou"] < 0.95 and np.isfinite(got["cd_m"]) and got["cd_m"] > 0
    np.testing.assert_allclose(got["cd_m"], want["cd"], rtol=0.05)
    np.testing.assert_allclose(got["fscore"], want["fscore"], rtol=0.1, atol=0.01)
