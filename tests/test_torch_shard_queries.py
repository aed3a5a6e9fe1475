"""``eval.inference.shard_queries`` (JAX ``rald_tpu/train/gen_engine.py:165``,
``:524-531``, ``:637-664``; ``rald_tpu/cli/infer.py:154-158``) in the port:
the ranks of a process group decode one batch together, rank 0 samples and
broadcasts the tokens, each rank decodes a run of whole query blocks and the
runs are gathered and trimmed (``GenerationEngine.decode_logits``).

One launch of two gloo ranks on the CPU (``tests/_torch_mp_worker.py
shard``, as ``tests/test_torch_parallel.py`` launches them; under 180 s,
every rank killed when one fails) runs ``shard_runs`` while this process
runs it at world 1 on the same inputs, made with numpy from a seed. At
world 2, bitwise the one-process result:

- ``decode_queries`` at 13289 queries (odd; 4 blocks of 4096, so the ranks
  take 2 blocks and 1 block + 1001 queries), at 1001 (one block: rank 1
  decodes nothing) and at 13296 (JAX's multiple of its 8 devices): the
  logits, trimmed to the query count;
- ``fused_eval_step`` (device grid of 5001 queries, 300 raw CFAR points
  densified to 3000 on the device, refine of 4500): loss, IoU, accuracy,
  CD, F, ``n_pred``;
- ``evaluate`` over a 3-frame split in batches of 2 (every rank reads the
  whole split), on the fused path and on the modular one, whose PLY files
  rank 0 alone writes;
- ``infer.run`` at batch 2 over five cubes: rank 0 writes the one-process
  PLY files byte for byte, rank 1 writes none.

Against ``rald_tpu``: JAX's ``decode_queries`` with ``shard_queries`` on the
tests' 8-device CPU mesh (as ``tests/test_generation.py::TestShardedQueryDecode``
builds it) and the port's world-2 decode of the same tokens and 13296
queries with the same weights, within JAX's own ``atol=1e-5``."""
import copy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rald_torch.config import Config as TConfig
from test_torch_parallel import _launch, _wait
from torch_parity import jax_engine_and_params, tiny_cfg, torch_engine

QUERIES = {"odd": 13289, "one_block": 1001, "jax": 13296}
BLOCK = 4096  # lidar_ae.overrides.query_chunk: the decode's block at batch 2


@pytest.fixture(autouse=True)
def _highest():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


def _shard(d: dict) -> dict:
    d["eval"]["inference"]["shard_queries"] = True
    d["lidar_ae"].setdefault("overrides", {})["query_chunk"] = BLOCK
    return d


def _engine(cfg):
    from rald_torch.train.gen_engine import GenerationEngine

    return GenerationEngine(cfg, device="cpu")


def _step_inputs(rng) -> dict:
    """One batch of 2 for ``fused_eval_step``, drawn with numpy."""
    helper_mask = rng.uniform(size=(2, 300)) < 0.8
    return {
        "radar_cube": rng.normal(size=(2, 32, 16, 16, 3)).astype(np.float32),
        "seeds_or_prior": [0, 1],
        "q_eval": rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32),
        "labels": (rng.uniform(size=(2, 512)) < 0.3).astype(np.float32),
        "qmask": np.ones((2, 512), np.float32), "grid": None,
        "helper": rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32), "helper_mask": helper_mask,
        "surface": rng.uniform(-1, 1, (2, 400, 3)).astype(np.float32),
        "surface_mask": np.ones((2, 400), bool), "helper_aug": True,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ``shard`` launch and, while it runs, the one-process run."""
    import _torch_mp_worker as worker
    import test_torch_infer as infer_tests
    from rald_torch.cli import infer
    from rald_torch.data.synthetic import make_synthetic_coloradar
    from test_torch_main_generation import _cfg as eval_cfg

    d = tmp_path_factory.mktemp("shard")
    tree = make_synthetic_coloradar(d / "tree", num_train_seqs=1, num_eval_seqs=1,
                                    frames_per_seq=3, points_per_frame=2000,
                                    radar_shape=(32, 16, 16), seed=2)
    _, params, vparams = jax_engine_and_params(0)
    cfg = _shard(tiny_cfg(TConfig).to_dict())
    cfg["dataset"]["query_aug_num"] = 3000
    cfg["eval"]["inference"].update(num_query_points=5001, refine_query=True,
                                    refine_query_aug_num=4500)
    eng = torch_engine(params, vparams)
    vae_sd = {k: v.clone() for k, v in eng.vae.state_dict().items()}
    rng = np.random.default_rng(11)
    tokens = rng.standard_normal((2, 16, 8)).astype(np.float32)
    # centre the occupancy bias on the tokens' logits: partial clouds
    probe = rng.uniform(-1, 1, (2, 4096, 3)).astype(np.float32)
    shift = float(np.median(eng.decode_queries(tokens, probe).numpy()))
    vae_sd["to_outputs.bias"] -= shift
    ecfg = eval_cfg(tree, d, **{"system.mode": "eval", "eval.store_pc": False})
    ecfg.eval.inference.update(num_query_points=5001, shard_queries=True, refine_query=True,
                               refine_query_aug_num=4500)
    ecfg.lidar_ae.overrides = {**(ecfg.lidar_ae.get("overrides") or {}), "query_chunk": BLOCK}
    icfg = infer_tests._cli_cfg(d)
    icfg.eval.inference.update(num_query_points=5001, shard_queries=True)
    icfg.lidar_ae.overrides.query_chunk = BLOCK
    infer_tests._raw_cubes(d / "cubes", {"seq_a": 3, "seq_b": 2})
    payload = {
        "cfg": cfg, "weights": (eng.model.state_dict(), vae_sd), "tokens": tokens,
        "queries": {n: rng.uniform(-1, 1, (2, q, 3)).astype(np.float32)
                    for n, q in QUERIES.items()},
        "step": _step_inputs(rng), "step_seed": 5,
        "eval_cfg": ecfg.to_dict(), "infer_cfg": icfg.to_dict(),
        "infer": {"input": str(d / "cubes"), "batch": 2, "threshold": 0.0},
        "bias_shift": shift,
    }
    ieng = _engine(icfg)
    files = infer.collect_inputs(str(d / "cubes"))
    cubes = np.stack([infer.preprocess(infer.load_cube(f), icfg.dataset.radar) for f in files[:2]])
    grid = infer.query_grid(icfg)
    logits = ieng.decode_queries(ieng.sample_tokens(cubes, [0, 1]),
                                 np.broadcast_to(grid, (2,) + grid.shape))
    payload["infer"]["threshold"] = float(torch.quantile(logits[0], 0.8))
    torch.save(payload, d / "shard.pt")
    t0 = time.monotonic()
    procs = _launch("shard", d)
    one = worker.shard_runs(copy.deepcopy(payload), d / "ply_one")
    outs = _wait(procs, "shard", d, t0)
    for rank, out in enumerate(outs):
        assert f"MP_SHARD_OK rank={rank}" in out, out
    two = [torch.load(d / f"shard_rank{r}.pt", weights_only=False) for r in range(2)]
    return d, payload, one, two


def test_one_process_flag_is_a_no_op(runs):
    """At world 1 the flag changes nothing: the plain decode."""
    _, payload, one, _ = runs
    plain = dict(payload["cfg"])
    plain["eval"] = copy.deepcopy(plain["eval"])
    plain["eval"]["inference"]["shard_queries"] = False
    eng = _engine(TConfig(plain))
    eng.load_state_dicts(*payload["weights"])
    for n, q in payload["queries"].items():
        assert torch.equal(eng.decode_queries(payload["tokens"], q), one["decode"][n]), n


@pytest.mark.parametrize("name", list(QUERIES))
def test_sharded_decode_is_bitwise_one_process(runs, name):
    _, _, one, two = runs
    assert one["query_shards"] == (1, 0)
    assert [t["query_shards"] for t in two] == [(2, 0), (2, 1)]
    want = one["decode"][name]
    assert want.shape == (2, QUERIES[name])  # trimmed: no padding survives
    for r in range(2):
        assert torch.equal(two[r]["decode"][name], want), (name, r)


def test_sharded_fused_eval_step_is_bitwise_one_process(runs):
    _, _, one, two = runs
    loss, iou, acc, cd, f, n_pred = one["step"]
    assert 0 < int(n_pred.min()) and torch.isfinite(cd).all() and torch.isfinite(f).all()
    for r in range(2):
        for got, want in zip(two[r]["step"], one["step"]):
            assert torch.equal(got, want), r


def _plys(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.ply"))}


@pytest.mark.parametrize("path", ["fused", "modular"])
def test_sharded_evaluate_is_bitwise_one_process(runs, path):
    """The fused step, and the modular path with its PLY dumps, which rank
    0 alone writes."""
    d, _, one, two = runs
    want = one["evaluate"][path]
    assert sorted(want) == ["accuracy", "cd", "fscore", "iou", "loss"]
    assert np.isfinite(want["cd"])
    assert two[0]["evaluate"][path] == two[1]["evaluate"][path] == want
    if path == "modular":
        dumps = _plys(d / "ply_one" / "dumps")
        assert len(dumps) == 3
        assert _plys(d / "ply_rank0" / "dumps") == dumps
        assert not (d / "ply_rank1" / "dumps").exists()


def test_sharded_infer_writes_the_one_process_files_on_rank_zero(runs):
    d, _, one, two = runs
    want = {k: v for k, v in _plys(d / "ply_one").items() if not k.startswith("dumps")}
    assert len(want) == 5 and any(len(v) > 300 for v in want.values())
    assert {k: v for k, v in _plys(d / "ply_rank0").items() if not k.startswith("dumps")} == want
    assert not (d / "ply_rank1").exists()
    assert two[0]["infer"]["points"] == two[1]["infer"]["points"] == one["infer"]["points"]
    assert two[0]["infer"]["files"] == 5


def test_port_sharded_decode_matches_jax_sharded_decode(runs):
    """JAX's query-sharded decode over its 8 CPU devices against the port's
    over two ranks, the same weights, tokens and 13296 queries (a multiple
    of 8, as JAX requires), at JAX's own ``atol=1e-5``."""
    _, payload, _, two = runs
    jeng, _, vparams = jax_engine_and_params(0)
    jeng = copy.copy(jeng)
    jeng.shard_queries = True
    vparams = jax.tree_util.tree_map(np.array, vparams)
    vparams["to_outputs"]["bias"] -= np.float32(payload["bias_shift"])
    q = payload["queries"]["jax"]
    assert q.shape[1] % jeng.mesh.devices.size == 0 and jeng.mesh.devices.size == 8
    want = jeng.decode_queries(vparams, jnp.asarray(payload["tokens"]), jnp.asarray(q))
    np.testing.assert_allclose(two[1]["decode"]["jax"].numpy(), np.asarray(want), atol=1e-5)
