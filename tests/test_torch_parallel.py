"""Multi-process runs of the port (``rald_torch.parallel`` on
``torch.distributed``), on the CPU in gloo processes, against the port in one
process and against ``rald_tpu`` in one process on the global batch.

In-process (no spawn): the rendezvous discovery (JAX's variables before
torchrun's, ``MASTER_PORT`` 12355 by default, a world of 1 needs nothing,
``WORLD_SIZE=2`` without ``MASTER_ADDR`` raises naming it, a rendezvous no
peer joins raises), ``draw_rows`` and the one-process identities.

Two launches of two ranks (``tests/_torch_mp_worker.py``, gloo, ``--device
cpu``, local batch 2, float32 with ``matmul_precision: highest``; each
launch under 180 s, every rank killed when one fails or the time runs out):

- ``steps``: two stage-2 steps (the tiny DiT with the frozen radar encoder,
  ``tests/test_torch_train_step.py``'s parity path) and two stage-1 steps
  (``tests/test_torch_ae_train.py``'s tiny VAE). With JAX's draws injected
  (each rank its rows of JAX's draws at the global batch of 4) both ranks
  match ``rald_tpu``'s single-process step on the concatenated batch, and
  with the engines' own generators they match the port's one-process step
  on it: loss 1e-5 relative, ``grad_norm`` 1e-4, params and EMA within
  ``k * 1e-6 + 2 * lr * k`` absolute after k steps (the bars of
  ``tests/test_torch_train_step.py``: Adam turns a gradient at rounding
  level, such as an attention key bias's, into an update of about lr). The
  two ranks' params and EMA are bitwise equal after every step. Then
  ``GenerationEngine.evaluate`` over each rank's shard of a 3-frame test
  split: both ranks report the same metrics, equal (1e-5 relative) to one
  process evaluating the padded global set (frames 0, 1, 2, 0) in global
  batches of 2; JAX would keep ``cd`` / ``fscore`` rank-local (ROADMAP C10).
- ``cli``: ``main_generation`` in train mode (one epoch of two steps, then a
  resumed second epoch): rank 0 alone writes ``config.yml``, ``log.txt``
  and the checkpoints, the resumed states are bitwise equal on both ranks
  and to the checkpoint; ``infer.run`` at batch 2: the union of the ranks'
  PLY files is the one-process run's, byte for byte; ``main_cache``: the
  union of the ranks' cache files is the one-process cache, bitwise.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _torch_mp_worker as worker
import test_torch_ae_train as s1mod
import test_torch_infer as infer_tests
import test_torch_main_generation_train as train_tests
import test_torch_train_step as s2mod

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mp_worker.py"
LAUNCH_TIMEOUT = 180
B = 4  # the global batch: 2 ranks x 2
DIST_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
             "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _highest():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture
def clean_env(monkeypatch):
    for var in DIST_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ in-process
def test_rendezvous_discovery_order(clean_env):
    from rald_torch.parallel import rendezvous

    assert rendezvous() == (None, 1, 0)
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")  # no WORLD_SIZE: one process, as in JAX
    assert rendezvous() == (None, 1, 0)
    clean_env.setenv("WORLD_SIZE", "4")
    clean_env.setenv("RANK", "3")
    assert rendezvous() == ("tcp://10.0.0.1:12355", 4, 3)
    clean_env.setenv("MASTER_PORT", "2345")
    assert rendezvous() == ("tcp://10.0.0.1:2345", 4, 3)
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.9:999")  # JAX's variables first
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "1")
    assert rendezvous() == ("tcp://10.0.0.9:999", 2, 1)
    clean_env.delenv("JAX_NUM_PROCESSES")
    clean_env.delenv("JAX_PROCESS_ID")
    assert rendezvous() == ("tcp://10.0.0.9:999", 4, 3)  # the counts fall back to torchrun's
    clean_env.setenv("RANK", "4")
    with pytest.raises(RuntimeError, match="RANK=4 outside WORLD_SIZE=4"):
        rendezvous()


def test_world_of_one_needs_nothing(clean_env):
    from rald_torch.parallel import init_distributed, local_device, process_info

    info = init_distributed("cpu")
    assert info == process_info() == {"rank": 0, "world_size": 1, "is_main_process": True,
                                      "local_device_count": 1, "global_device_count": 1}
    assert not torch.distributed.is_initialized()
    clean_env.setenv("WORLD_SIZE", "1")
    assert init_distributed("cpu")["world_size"] == 1
    assert not torch.distributed.is_initialized()
    assert local_device() == torch.device("cuda:0") and local_device("cpu").type == "cpu"
    clean_env.setenv("LOCAL_RANK", "3")
    assert local_device() == torch.device("cuda:3")


def test_world_size_two_without_an_address_raises(clean_env):
    from rald_torch.parallel import init_distributed

    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2.*MASTER_ADDR"):
        init_distributed("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rendezvous_no_peer_joins_raises(clean_env, rank):
    """Rank 0 waits for a peer that never comes, rank 1 for a store nobody
    serves: both raise within the timeout; neither runs alone."""
    from rald_torch.parallel import dist, init_distributed

    clean_env.setattr(dist, "TIMEOUT", datetime.timedelta(seconds=2))
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", str(_free_port()))
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", str(rank))
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        init_distributed("cpu")
    assert "time" in str(err.value).lower() and time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()


def test_draw_rows_takes_the_ranks_rows_of_the_global_draw(monkeypatch):
    from rald_torch.parallel import dist

    def draw(shape, world, rank, seed=3):
        monkeypatch.setattr(dist, "world_rank", lambda: (world, rank))
        return dist.draw_rows(torch.randn, shape, generator=torch.Generator().manual_seed(seed))

    whole = draw((6, 4), 1, 0)
    assert torch.equal(whole, torch.randn((6, 4), generator=torch.Generator().manual_seed(3)))
    parts = [draw((2, 4), 3, r) for r in range(3)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(parts[0], parts[1])


def test_one_process_reductions_are_identities():
    from rald_torch.parallel import all_reduce_mean_, all_reduce_sum
    from rald_torch.train.metrics import MetricLogger

    ts = [torch.arange(6.0).reshape(2, 3), torch.tensor(2.5)]
    want = [t.clone() for t in ts]
    all_reduce_mean_(ts)
    assert all(torch.equal(a, b) for a, b in zip(ts, want))
    assert all_reduce_sum([3, 0.25]) == [3.0, 0.25]
    logger = MetricLogger(print_fn=lambda *_: None)
    logger.update(cd=1.0, fscore=0.5)
    logger.update(cd=2.0, fscore=0.25)
    logger.synchronize_between_processes()
    assert logger.averages() == {"cd": 1.5, "fscore": 0.375}
    assert logger.meters["cd"].count == 2


# ------------------------------------------------------------ launches
def _launch(job: str, d: Path) -> list:
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank))
        log = open(d / f"{job}_rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, str(WORKER), job, str(d)], env=env,
                                      cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def _wait(procs: list, job: str, d: Path, t0: float) -> list:
    """Both ranks' output; every rank is killed when one fails or the
    launch's time runs out."""
    def logs():
        return [(d / f"{job}_rank{r}.log").read_text() for r in range(len(procs))]

    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() - t0 > LAUNCH_TIMEOUT:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            pytest.fail(f"{job}: {'a rank failed' if failed else 'timed out'}:\n"
                        + "\n".join(logs()))
        time.sleep(0.2)
    outs = logs()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{job} rank {rank} failed:\n{out}"
        assert f"MP_DONE rank={rank}" in out, out
    return outs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three train sequences and a test sequence of 3 frames each."""
    from rald_torch.data.synthetic import make_synthetic_coloradar

    root = tmp_path_factory.mktemp("mp_tree")
    make_synthetic_coloradar(root, num_train_seqs=3, num_eval_seqs=1, frames_per_seq=3,
                             points_per_frame=2000, radar_shape=(32, 16, 16), seed=2)
    return root


def _state_payload(state) -> tuple:
    return ({k: v.clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.ema_params.items()},
            {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in state.opt_state().items()}, state.step)


def _stage2_inputs():
    """Stage 2: JAX's fresh state carried into the port, the global batches
    and JAX's draws (``edm_loss``'s split of each step's key)."""
    _, params, fresh, jstep = s2mod._jax_engine(True)
    jstate = fresh(params)
    _, tstate = s2mod._torch_side(jstate, True)
    payload = {"cfg": s2mod._cfg_dict(True), "state": _state_payload(tstate),
               "lat": [], "cond": [], "rnd": [], "noise": [], "keys": []}
    for k in range(worker.STEPS):
        rng = np.random.default_rng(200 + k)
        key = jax.random.PRNGKey(20 + k)
        rs, rn = jax.random.split(key)
        payload["lat"].append(torch.from_numpy(rng.standard_normal((B, s2mod.M, s2mod.C))
                                               .astype(np.float32)))
        payload["cond"].append(torch.from_numpy(rng.standard_normal((B, 2, 2, 2, 4))
                                                .astype(np.float32)))
        payload["rnd"].append(torch.from_numpy(np.array(jax.random.normal(rs, (B, 1, 1)))))
        payload["noise"].append(torch.from_numpy(np.array(
            jax.random.normal(rn, (B, s2mod.M, s2mod.C)))))
        payload["keys"].append(key)
    return payload, jstate, jstep


def _stage1_inputs():
    """Stage 1: the same, with JAX's posterior noise and drop-path masks at
    the global batch (recorded as ``tests/test_torch_ae_train.py`` does)."""
    _, params, fresh, jstep, record = s1mod._jax_engine()
    jstate = fresh(params)
    _, tstate = s1mod._torch_side(jstate)
    payload = {"cfg": s1mod._cfg_dict(), "state": _state_payload(tstate), "batches": [],
               "eps": [], "masks": [], "keys": []}
    for k in range(worker.STEPS):
        batch, key = s1mod._batch(30 + k, n_batch=B), jax.random.PRNGKey(30 + k)
        _, eps, masks = record(params, batch["lidar_points"], batch["query_points"], key)
        payload["batches"].append({n: torch.from_numpy(v) for n, v in batch.items()})
        payload["eps"].append(torch.from_numpy(np.array(eps)))
        payload["masks"].append({s: torch.from_numpy(np.array(m)) for s, m in masks.items()})
        payload["keys"].append(key)
    return payload, jstate, jstep


def _jax_stage2(payload, jstate, jstep) -> list:
    out = []
    for k in range(worker.STEPS):
        _, jstate, m = jstep(jstate, jnp.asarray(payload["lat"][k].numpy()),
                             jnp.asarray(payload["cond"][k].numpy()), payload["keys"][k])
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "params": s2mod._sd(jstate.params), "ema": s2mod._sd(jstate.ema_params)})
    return out


def _jax_stage1(payload, jstate, jstep) -> list:
    out = []
    for k in range(worker.STEPS):
        batch = {n: v.numpy() for n, v in payload["batches"][k].items()}
        _, jstate, m = jstep(jstate, batch, payload["keys"][k])
        out.append({**{n: float(v) for n, v in m.items()},
                    "params": s1mod._sd(jstate.params), "ema": s1mod._sd(jstate.ema_params)})
    return out


def _eval_cfg(tree, out):
    from test_torch_main_generation import _cfg

    # store_pc off: the one-step fused path, whose draws are all on the device
    return _cfg(tree, out, **{"system.mode": "eval", "eval.store_pc": False})


@pytest.fixture(scope="module")
def steps(tree, tmp_path_factory):
    """The ``steps`` launch, and while it runs the references: JAX's steps
    and the port's one-process steps on the global batches, and the
    one-process evaluation of the padded global set."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine

    d = tmp_path_factory.mktemp("mp_steps")
    with jax.default_matmul_precision("highest"):
        s2, j2state, j2step = _stage2_inputs()
        s1, j1state, j1step = _stage1_inputs()
        keys2, keys1 = s2.pop("keys"), s1.pop("keys")
        torch.save(s2, d / "s2.pt")
        torch.save(s1, d / "s1.pt")
        cfg = _eval_cfg(tree, d)
        (d / "eval.yml").write_text(yaml.safe_dump(cfg.to_dict()))
        t0 = time.monotonic()
        procs = _launch("steps", d)
        s2["keys"], s1["keys"] = keys2, keys1
        ref = {"jax2": _jax_stage2(s2, j2state, j2step), "jax1": _jax_stage1(s1, j1state, j1step),
               "one2": worker.stage2_runs(s2, slice(0, B)),
               "one1": worker.stage1_runs(s1, slice(0, B))}
        cfg.dataset.eval_batch_size = 2
        loader = mg.build_eval_loader(cfg, "eval", print_fn=lambda *_: None)
        loader.sampler = [0, 1, 2, 0]  # the ranks' shards (0, 2) and (1, 0), interleaved
        ref["eval"] = GenerationEngine(cfg, device="cpu").evaluate(loader,
                                                                   print_fn=lambda *_: None)
        outs = _wait(procs, "steps", d, t0)
    for rank, out in enumerate(outs):
        for mark in ("MP_INIT_OK", "MP_S2_OK", "MP_S1_OK", "MP_EVAL_OK"):
            assert f"{mark} rank={rank}" in out, out
    ranks = {f"s{s}": [torch.load(d / f"s{s}_rank{r}.pt", weights_only=False) for r in range(2)]
             for s in (1, 2)}
    ranks["eval"] = [json.loads((d / f"eval_rank{r}.json").read_text()) for r in range(2)]
    return ranks, ref, {"s2": s2, "s1": s1}


def _worst(a: dict, b: dict) -> float:
    assert sorted(a) == sorted(b)
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def _assert_close_steps(got: list, want: list, lr_schedule, what: str, metrics=("loss",)):
    lr_sum = 0.0
    for k, (g, w) in enumerate(zip(got, want), start=1):
        lr_sum += lr_schedule(k - 1)
        for m in metrics:
            assert g[m] == pytest.approx(w[m], rel=1e-5, abs=1e-12), (what, k, m)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4), (what, k)
        bar = k * 1e-6 + 2 * lr_sum
        for tree in ("params", "ema"):
            assert _worst(g[tree], w[tree]) <= bar, (what, k, tree)


def _schedule(stage):
    from rald_torch.train.schedule import warmup_cosine_schedule

    lr = s2mod.LR if stage == "s2" else s1mod.LR
    return warmup_cosine_schedule(lr, 1e-6, 0, 2, 4)


@pytest.mark.parametrize("stage", ["s2", "s1"])
@pytest.mark.parametrize("mode", ["injected", "generator"])
def test_ranks_hold_bitwise_equal_states(steps, stage, mode):
    ranks, _, _ = steps
    r0, r1 = (ranks[stage][r][mode] for r in range(2))
    for a, b in zip(r0, r1):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for tree in ("params", "ema"):
            assert all(torch.equal(a[tree][n], b[tree][n]) for n in a[tree]), tree


@pytest.mark.parametrize("stage", ["s2", "s1"])
def test_two_ranks_match_jax_on_the_global_batch(steps, stage):
    """JAX's draws injected: each rank's steps against ``rald_tpu``'s
    single-process steps on the concatenated batch."""
    ranks, ref, payload = steps
    metrics = ("loss",) if stage == "s2" else ("loss", "loss_vol", "loss_near", "loss_kl",
                                               "iou", "accuracy")
    if stage == "s1":  # the masks drop some samples, and not the same on both ranks' rows
        masks = torch.stack([torch.stack(list(m.values())) for m in payload["s1"]["masks"]])
        assert not bool(masks.all()) and not torch.equal(masks[..., :2], masks[..., 2:])
    for r in range(2):
        _assert_close_steps(ranks[stage][r]["injected"], ref[f"jax{stage[1]}"], _schedule(stage),
                            f"{stage} rank {r} vs JAX", metrics)


@pytest.mark.parametrize("stage", ["s2", "s1"])
@pytest.mark.parametrize("mode", ["injected", "generator"])
def test_two_ranks_match_one_process_on_the_global_batch(steps, stage, mode):
    """With the engines' own generators a world-2 step draws the rows of
    the one-process step's draws (never the same noise on both ranks), so
    it equals that step up to the order of the gradient sum."""
    ranks, ref, _ = steps
    metrics = ("loss",) if stage == "s2" else ("loss", "iou", "accuracy")
    _assert_close_steps(ranks[stage][0][mode], ref[f"one{stage[1]}"][mode], _schedule(stage),
                        f"{stage} {mode} world 2 vs 1", metrics)


def test_evaluate_reduces_the_meters_over_the_ranks(steps):
    """Both ranks report the same ``cd`` / ``fscore`` / loss / IoU: the mean
    over every rank's frames, which one process evaluating the padded
    global set reports."""
    ranks, ref, _ = steps
    r0, r1 = ranks["eval"]
    assert r0 == r1
    assert sorted(r0) == ["accuracy", "cd", "fscore", "iou", "loss"]
    assert np.isfinite(r0["cd"]) and r0["cd"] > 0
    for k, v in ref["eval"].items():
        assert r0[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


# ------------------------------------------------------------ the CLIs
def _tree_bytes(root: Path, pattern: str) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob(pattern))}


@pytest.fixture(scope="module")
def cli(tree, tmp_path_factory):
    """The ``cli`` launch, and while it runs the one-process ``infer`` and
    ``main_cache``."""
    from rald_torch.cli import infer, main_cache
    from rald_torch.train.gen_engine import GenerationEngine

    d = tmp_path_factory.mktemp("mp_cli")
    out = d / "train_out"
    train = train_tests._cfg(tree, out, **{"train.epochs": 1, "train.eval_freq": 0,
                                          "dataset.num_workers": 1})
    (d / "train.yml").write_text(yaml.safe_dump(train.to_dict()))
    resume = train_tests._cfg(tree, out, **{"train.epochs": 2, "train.eval_freq": 0,
                                           "dataset.num_workers": 1,
                                           "train.resume": str(out / "checkpoint-0.pth")})
    (d / "resume.yml").write_text(yaml.safe_dump(resume.to_dict()))
    cache = {w: train_tests._cfg(tree, d / f"cache_run{w}",
                                 **{"lidar_ae.cache_path": str(d / f"cache{w}"),
                                    "dataset.num_workers": 1}) for w in (1, 2)}
    (d / "cache.yml").write_text(yaml.safe_dump(cache[2].to_dict()))
    icfg = infer_tests._cli_cfg(d)
    (d / "infer.yml").write_text(yaml.safe_dump(icfg.to_dict()))
    infer_tests._raw_cubes(d / "cubes", {"seq_a": 3, "seq_b": 2})
    eng = GenerationEngine(icfg, device="cpu")
    files = infer.collect_inputs(str(d / "cubes"))
    cubes = np.stack([infer.preprocess(infer.load_cube(f), icfg.dataset.radar) for f in files[:2]])
    grid = infer.query_grid(icfg)
    logits = eng.decode_queries(eng.sample_tokens(cubes, [0, 1]),
                                np.broadcast_to(grid, (2,) + grid.shape))
    spec = {"input": str(d / "cubes"), "out": str(d / "ply2"), "batch": 2,
            "threshold": float(torch.quantile(logits[0], 0.8))}
    (d / "infer.json").write_text(json.dumps(spec))
    t0 = time.monotonic()
    procs = _launch("cli", d)
    infer.run(icfg, spec["input"], str(d / "ply1"), batch=2, threshold=spec["threshold"],
              device="cpu", print_fn=lambda *_: None)
    main_cache.run(cache[1], device="cpu", print_fn=lambda *_: None)
    outs = _wait(procs, "cli", d, t0)
    return d, out, outs


def test_only_rank_zero_writes_logs_config_and_checkpoints(cli):
    d, out, outs = cli
    for rank, text in enumerate(outs):
        line = next(l for l in text.splitlines() if l.startswith(f"MP_WRITES rank={rank} "))
        written = json.loads(line.split(" ", 2)[2])
        want = ["checkpoint-0.pth.tmp", "checkpoint-1.pth.tmp", "config.yml", "config.yml",
                "log.txt", "log.txt"]
        assert written == (want if rank == 0 else []), (rank, written)
    assert sorted(p.name for p in out.iterdir()) == ["checkpoint-0.pth", "checkpoint-1.pth",
                                                     "config.yml", "log.txt"]
    records = [json.loads(l) for l in (out / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in records)


def test_resumed_states_are_bitwise_equal_on_both_ranks(cli):
    d, out, outs = cli
    for rank, text in enumerate(outs):
        assert f"MP_RESUME_OK rank={rank} restored_equal=True step=4" in text, text
    s0, s1 = (torch.load(d / f"cli_rank{r}.pt", weights_only=False) for r in range(2))
    ck = torch.load(out / "checkpoint-1.pth", weights_only=False)
    for key, file_key in (("params", "model"), ("ema", "model_ema")):
        for n in s0[key]:
            assert torch.equal(s0[key][n], s1[key][n]) and torch.equal(s0[key][n], ck[file_key][n])
    for n in s0["opt"]["mu"]:
        assert torch.equal(s0["opt"]["mu"][n], s1["opt"]["mu"][n])
        assert torch.equal(s0["opt"]["nu"][n], s1["opt"]["nu"][n])
    assert s0["step"] == s1["step"] == ck["step"] == 4


def test_infer_union_of_the_ranks_is_the_one_process_run(cli):
    d, _, outs = cli
    for rank, text in enumerate(outs):
        assert f"MP_INFER_OK rank={rank} files={3 - rank}" in text, text
    one, two = _tree_bytes(d / "ply1", "*.ply"), _tree_bytes(d / "ply2", "*.ply")
    assert sorted(one) == sorted(two) and len(one) == 5
    assert all(one[k] == two[k] for k in one)
    assert any(len(v) > 300 for v in one.values())  # clouds, not empty headers


def test_cache_union_of_the_ranks_is_the_one_process_cache(cli):
    d, _, outs = cli
    for rank, text in enumerate(outs):
        assert f"MP_CACHE_OK rank={rank}" in text, text
    one, two = (_tree_bytes(d / f"cache{w}", "*.npz") for w in (1, 2))
    assert len(one) == 9 and sorted(one) == sorted(two)
    for k in one:
        with np.load(d / "cache1" / k) as a, np.load(d / "cache2" / k) as b:
            np.testing.assert_array_equal(a["res_tokens"], b["res_tokens"])
    assert not list((d / "cache2").rglob("*.tmp*"))
