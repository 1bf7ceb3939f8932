"""Readings of the program and of the control for a cell, on several seeds
in one process: the numbers that set the limits of ``correct``.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

The control is the plain reference, computed in the precision below the one
the configuration states, put in the program's place, as each oracle in
``oracles/`` reads it: bfloat16 for the float32 images, the point searches'
geometry and the pose solve, int8 sums for the int32 Hamming distances; the
program's lost frames are the reference's (none). Each seed prints one
JSON line: the program's readings, the control's, and the run's end-to-end
metrics. The benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark.cell import run_cell
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 1
    spec = Spec()
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(spec, args.workload, seed, args.seconds, False, t, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": out["readings"],
                          "control": out["control"], "correct": out["correct"],
                          "metrics": out["metrics"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
