"""The readings that the limits of a cell's correctness check are set from:
the program's numbers over many seeds, and the control's, in one process.

    python -m rald_bench.readings --workload <cell> --seeds 1 2 3 ... [--control] [--int8] [--out F]

For each seed: the cell's set-up with that seed's weights and traffic, the
cell's checked steps (eval: ``check_batches`` steps after the warm-up;
training: the first steps), and the numbers the run compares. With
``--control``: the same numbers of the control, the plain reference in
float8 e4m3 put in the program's place (and for training the half-batch
fault). With ``--int8``: an eval cell's numbers of the program's own int8
path (``int8_ff: true``, ``int8_attn: full``). The benchmark's runs never
run this; the limits files (``limits/<cell>.json``) record what it read."""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time


def readings(cell: dict, seeds: list, control: bool, int8: bool, device="cuda", log=print) -> list:
    from rald_bench.run import driver_class

    cells = [("program", cell)]
    if int8:
        c8 = copy.deepcopy(cell)
        c8["config"]["config"]["eval"]["inference"].update({"int8_ff": True, "int8_attn": "full"})
        cells.append(("program_int8", c8))
    out = []
    for label, c in cells:
        drv = driver_class(c["traffic"]["driver"])(c, device)
        for seed in seeds:
            t0 = time.perf_counter()
            drv.setup(seed)
            line = {"workload": cell["name"], "seed": seed, "side": label}
            if c["traffic"]["driver"] == "eval_stream":
                n = int(c["traffic"]["check_batches"])
                drv.check_ks = set(range(drv.next_step, drv.next_step + n))
                for k in sorted(drv.check_ks):
                    drv.step(k)
                drv.next_step += n
                recs, drv.records = drv.records, []
                line["numbers"] = drv.judge(recs)
                if control and label == "program":
                    line["control"] = drv.judge(recs, control=True)
            else:
                line["numbers"] = drv.judge()
                if control:
                    line["control"] = drv.judge(control=True)
                    line["fault_half"] = drv.judge(fault="half")
            line["seconds"] = time.perf_counter() - t0
            log(json.dumps(line))
            out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from rald_bench import spec

    lines = readings(spec.cell(args.workload), args.seeds, args.control, args.int8,
                     log=lambda s: print("[readings] " + s, flush=True))
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
