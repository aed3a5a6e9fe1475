"""One rank of a two-process gloo group for ``tests/test_torch_parallel.py``.

    python tests/_torch_mp_worker.py steps|cli|shard <dir>

with ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE=2`` / ``RANK`` set, as
``torchrun`` sets them. It imports torch and ``rald_torch`` only; the test
writes the inputs into ``<dir>`` and holds the results against the
one-process port and against ``rald_tpu``. Each check prints one marker line.

- ``steps``: two stage-2 train steps (``GenerationEngine``) and two stage-1
  train steps (``AEEngine``) from the test's state, each rank on its rows
  of the global batch, once with the test's injected draws (the rank's rows
  of JAX's) and once with the engines' own generators; then
  ``GenerationEngine.evaluate`` over this rank's shard of a synthetic test
  split, whose meters are averaged over the ranks.
- ``cli``: ``main_generation`` in train mode (one epoch, then a resumed
  second), recording which files each rank writes; ``infer.run`` over the
  test's cubes; ``main_cache``.
- ``shard`` (``tests/test_torch_shard_queries.py``): with
  ``eval.inference.shard_queries`` the two ranks decode one batch together:
  ``decode_queries``, ``fused_eval_step``, ``evaluate`` and ``infer.run``
  (:func:`shard_runs`, which the test runs in one process too).

The step loops (:func:`stage2_runs`, :func:`stage1_runs`) are the ones the
test runs in one process on the whole batch.
"""
import json
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 2


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _load_state(state, payload):
    params, ema, opt, step = payload["state"]
    return state.load(params, ema, opt, step)


def stage2_runs(payload: dict, rows: slice) -> dict:
    """``STEPS`` stage-2 steps on ``rows`` of each global batch, per draw
    mode (``injected``: the payload's ``rnd`` / ``noise`` rows;
    ``generator``: ``step_generator(0, k)``): per step the loss, grad norm,
    params and EMA."""
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    out = {}
    for mode in ("injected", "generator"):
        eng = GenerationEngine(Config(payload["cfg"]), device="cpu")
        state = _load_state(eng.init_state(4, 4), payload)
        rec = []
        for k in range(STEPS):
            lat, cond = payload["lat"][k][rows], payload["cond"][k][rows]
            if mode == "injected":
                draws = {"rnd": payload["rnd"][k][rows], "noise": payload["noise"][k][rows]}
            else:
                draws = {"generator": eng.step_generator(0, k)}
            state, m = eng.train_step(state, lat, cond, **draws)
            rec.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                        "params": _clone(state.params), "ema": _clone(state.ema_params)})
        out[mode] = rec
    return out


def stage1_runs(payload: dict, rows: slice) -> dict:
    """The same for ``AEEngine`` (``injected``: the payload's posterior noise
    and drop-path mask rows), with every metric of the step."""
    from rald_torch.config import Config
    from rald_torch.train.ae_engine import AEEngine

    out = {}
    for mode in ("injected", "generator"):
        eng = AEEngine(Config(payload["cfg"]), device="cpu")
        state = _load_state(eng.init_state(4, 4), payload)
        rec = []
        for k in range(STEPS):
            batch = {n: v[rows] for n, v in payload["batches"][k].items()}
            if mode == "injected":
                draws = {"eps": payload["eps"][k][rows],
                         "drop_masks": {s: m[rows] for s, m in payload["masks"][k].items()}}
            else:
                draws = {"generator": eng.step_generator(0, k)}
            state, m = eng.train_step(state, batch, **draws)
            rec.append({**{n: float(v) for n, v in m.items()},
                        "params": _clone(state.params), "ema": _clone(state.ema_params)})
        out[mode] = rec
    return out


def evaluate(cfg_path) -> dict:
    """``GenerationEngine.evaluate`` over ``build_eval_loader``'s loader (this
    rank's shard under a process group), seeded random weights."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.config import load_config
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = load_config(cfg_path)
    loader = mg.build_eval_loader(cfg, "eval", print_fn=lambda *_: None)
    return GenerationEngine(cfg, device="cpu").evaluate(loader, print_fn=lambda *_: None)


def job_steps(d: Path, rank: int) -> None:
    from rald_torch.parallel import init_distributed, process_info

    info = init_distributed("cpu")
    assert info == process_info() and info["world_size"] == 2 and info["rank"] == rank, info
    assert torch.distributed.get_backend() == "gloo"
    print(f"MP_INIT_OK rank={rank}", flush=True)
    rows = slice(2 * rank, 2 * rank + 2)
    torch.save(stage2_runs(torch.load(d / "s2.pt", weights_only=False), rows),
               d / f"s2_rank{rank}.pt")
    print(f"MP_S2_OK rank={rank}", flush=True)
    torch.save(stage1_runs(torch.load(d / "s1.pt", weights_only=False), rows),
               d / f"s1_rank{rank}.pt")
    print(f"MP_S1_OK rank={rank}", flush=True)
    stats = evaluate(d / "eval.yml")
    (d / f"eval_rank{rank}.json").write_text(json.dumps(stats))
    print(f"MP_EVAL_OK rank={rank} cd={stats['cd']!r}", flush=True)


def _record_writes(written: list):
    """Note every checkpoint, log record and config snapshot this process
    writes (the CLIs' own calls, wrapped)."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.train import checkpoint, metrics

    save, write, dump = checkpoint.torch.save, metrics.JsonlLogger.write, mg.dump_config

    def saving(obj, path, *a, **k):
        written.append(Path(path).name)
        return save(obj, path, *a, **k)

    def logging(self, record):
        if self.enabled:
            written.append(self.path.name)
        return write(self, record)

    def dumping(cfg, path):
        written.append(Path(path).name)
        return dump(cfg, path)

    checkpoint.torch.save = saving
    metrics.JsonlLogger.write = logging
    mg.dump_config = dumping
    return lambda: (setattr(checkpoint.torch, "save", save),
                    setattr(metrics.JsonlLogger, "write", write),
                    setattr(mg, "dump_config", dump))


def job_cli(d: Path, rank: int) -> None:
    from rald_torch.cli import infer, main_cache
    from rald_torch.cli import main_generation as mg
    from rald_torch.config import finalize_dirs, load_config
    from rald_torch.train.checkpoint import CheckpointManager
    from rald_torch.train.gen_engine import GenerationEngine

    written = []
    restore = _record_writes(written)
    mg.main(["--config", str(d / "train.yml"), "--device", "cpu"])
    cfg = finalize_dirs(load_config(d / "resume.yml"))
    eng = GenerationEngine(cfg, device="cpu")
    captured, init = {}, eng.init_state

    def init_state(*a):
        captured["state"] = init(*a)
        return captured["state"]

    eng.init_state = init_state
    mg.run(cfg, device="cpu", engine=eng, print_fn=lambda *_: None)
    restore()
    state = captured["state"]
    print(f"MP_WRITES rank={rank} {json.dumps(sorted(written))}", flush=True)
    fresh = eng.init_state(1, 4)
    CheckpointManager(cfg.system.output_dir).restore(fresh, 1)
    same = all(torch.equal(a[k], b[k]) for a, b in ((state.params, fresh.params),
                                                    (state.ema_params, fresh.ema_params))
               for k in a)
    torch.save({"params": state.params, "ema": state.ema_params, "opt": state.opt_state(),
                "step": state.step}, d / f"cli_rank{rank}.pt")
    print(f"MP_RESUME_OK rank={rank} restored_equal={same} step={state.step}", flush=True)
    spec = json.loads((d / "infer.json").read_text())
    stats = infer.run(load_config(d / "infer.yml"), spec["input"], spec["out"],
                      batch=spec["batch"], threshold=spec["threshold"], device="cpu",
                      print_fn=lambda *_: None)
    print(f"MP_INFER_OK rank={rank} files={stats['files']}", flush=True)
    main_cache.main(["--config", str(d / "cache.yml"), "--device", "cpu"])
    print(f"MP_CACHE_OK rank={rank}", flush=True)


def shard_runs(payload: dict, out_dir: Path) -> dict:
    """The ``shard_queries`` paths on the payload's inputs: each query set
    through ``decode_queries`` (the payload's weights), one
    ``fused_eval_step``, ``evaluate`` over the payload's split on the fused
    path and on the modular one (its PLY dumps under ``out_dir/dumps``) and
    ``infer.run`` (seeded random weights) into ``out_dir``; the outputs on
    the host."""
    from rald_torch.cli import infer
    from rald_torch.cli import main_generation as mg
    from rald_torch.config import Config
    from rald_torch.train.gen_engine import GenerationEngine

    eng = GenerationEngine(Config(payload["cfg"]), device="cpu")
    eng.load_state_dicts(*payload["weights"])
    out = {"query_shards": eng.query_shards(),
           "decode": {n: eng.decode_queries(payload["tokens"], q)
                      for n, q in payload["queries"].items()}}
    step = dict(payload["step"], generator=torch.Generator().manual_seed(payload["step_seed"]))
    out["step"] = [t.clone() for t in eng.fused_eval_step(**step)]
    out["evaluate"] = {}
    for path, store_pc in (("fused", False), ("modular", True)):  # modular: PLY dumps
        ecfg = Config(payload["eval_cfg"])
        ecfg.eval.update(store_pc=store_pc, store_base_dir=str(out_dir / "dumps"))
        out["evaluate"][path] = GenerationEngine(ecfg, device="cpu").evaluate(
            mg.build_eval_loader(ecfg, "eval", print_fn=lambda *_: None),
            print_fn=lambda *_: None)
    spec = payload["infer"]
    out["infer"] = infer.run(Config(payload["infer_cfg"]), spec["input"], str(out_dir),
                             batch=spec["batch"], threshold=spec["threshold"], device="cpu",
                             print_fn=lambda *_: None)
    return out


def job_shard(d: Path, rank: int) -> None:
    from rald_torch.parallel import init_distributed

    info = init_distributed("cpu")
    assert info["world_size"] == 2 and info["rank"] == rank, info
    out = shard_runs(torch.load(d / "shard.pt", weights_only=False), d / f"ply_rank{rank}")
    torch.save(out, d / f"shard_rank{rank}.pt")
    print(f"MP_SHARD_OK rank={rank}", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    job, d = sys.argv[1], Path(sys.argv[2])
    rank = int(os.environ["RANK"])
    {"steps": job_steps, "cli": job_cli, "shard": job_shard}[job](d, rank)
    from rald_torch.parallel import destroy

    destroy()
    print(f"MP_DONE rank={rank}", flush=True)


if __name__ == "__main__":
    main()
