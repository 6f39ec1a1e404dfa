"""The control's readings (the upper readings of the output check's
limits):

    python3 -m rtbench.tools.control --workload <cell> --seeds a,b,c
        [--seconds 1]

For each seed, one run of the cell as the benchmark makes it (set-up, a
short window at the cell's own load, the check, the limits and
``correct``), with the control in the program's place
(``control.stand_in``: the plain reference computed a precision lower than
the configuration states). Each run's result line is printed; the control
has to come out not correct. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

from rtbench import control, core


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = core.Cell.find(args.workload)
    core._cache_dirs()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = core.execute(cell, seed, args.seconds, False, device="cuda:0",
                           t_start=time.perf_counter(), stand_in=control.stand_in)
        print(json.dumps(dict(out, seed=seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
