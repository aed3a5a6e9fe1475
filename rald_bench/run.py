"""The benchmark of ``rald_torch`` on NVIDIA GPUs.

    python -m rald_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell named in ``BENCHMARK.json`` from its files, sets it up
(weights and inputs from ``--seed``, every shape warmed), runs its traffic
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics), ``device``, and with
``--trace 1`` ``breakdown``; ``checks`` (each compared number with its
limit) comes last. Exits 2 without a card or without the chips the cell
asks for, and 3 when ``jax``, ``jaxlib``, ``flax`` or ``rald_tpu`` was
loaded, printing no result."""
from __future__ import annotations

import time

T_START = time.perf_counter()  # before the heavy imports: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rald_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``rald_torch`` is not ``rald_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def driver_class(name: str):
    import importlib

    return importlib.import_module(f"rald_bench.drivers.{name}").Driver


def per_layer(cell: dict, ctx: dict) -> dict:
    from rald_bench import spec

    out = {}
    for name, m in cell["per_layer"].items():
        value = spec.metric_reader(name).read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": m["unit"]}
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        log=print) -> dict:
    """One run of ``cell`` (:func:`rald_bench.spec.cell`) on ``device``;
    returns the result line's object. ``log`` gets the earlier lines."""
    import torch

    from rald_bench import spec
    from rald_bench.trace import OpRanges

    workload = cell["name"]
    drv = driver_class(cell["traffic"]["driver"])(cell, device)
    ops = None
    if trace:
        readers = {}
        for name in cell["per_layer"]:
            mod = spec.metric_reader(name)
            if getattr(mod, "OP", None):
                readers[mod.OP] = mod
    drv.setup(seed)
    if trace:
        ops = OpRanges(readers)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"[setup] {setup_s:.3f} s: " + json.dumps({k: round(v, 3) for k, v in drv.setup_split.items()}))
    res = drv.window(seconds, trace, ops)
    if ops is not None:
        ops.restore()
    dev = (device_info(torch, cell["chips"]) if device != "cpu"
           else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    log(f"[drift] {workload} frames/s in each tenth of the {res['window_s']:.3f} s window: "
        + json.dumps([round(v, 4) for v in res["drift"]]))
    metrics = {}
    if trace:
        ctx = res["ctx"]
        ctx["cell"] = cell
        metrics = per_layer(cell, ctx)
        for op, times in ctx["summary"]["op_calls"].items():
            log(f"[trace] {op}: {len(times)} host ranges, {len(ops.calls[op])} calls described, "
                f"{sum(times):.6f} s of kernels inside them")
        log(f"[trace] {ctx['summary']['attributed_kernels']} kernels inside op ranges; "
            f"{ctx['summary']['kernels']} kernels, busy {ctx['summary']['busy_s']:.6f} s of "
            f"{ctx['summary']['window_s']:.6f} s traced, {ctx['stage_steps']} timed steps after")
        dev["busy_s"] = ctx["summary"]["busy_s"]
        dev["window_s"] = ctx["summary"]["window_s"]
    else:
        e2e = {**res["end_to_end"], "setup_s": setup_s}
        metrics = {n: {"value": float(e2e[n]), "unit": m["unit"]}
                   for n, m in cell["end_to_end"].items() if n in e2e}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    recs = drv.release()
    numbers = drv.judge(recs)
    limits = cell["limits"]["limits"]
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items() if n in limits}
    failed_checks = [n for n, c in checks.items() if not (c["value"] <= c["limit"])]
    out = {"correct": not failed_checks and len(checks) == len(limits),
           "attempted": res["frames"], "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = ctx["summary"]["breakdown"]
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    _cache_dirs(root)
    import torch

    from rald_bench import spec

    cell = spec.cell(args.workload)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rald_bench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[device] {smi()}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace),
                  log=lambda s: print(s, flush=True))
    except ForbiddenImport as e:
        print(f"rald_bench: loaded in this process: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
