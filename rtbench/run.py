"""The benchmark's one command:

    python3 -m rtbench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (gpuraytracer_tpu_torch).
It needs as many CUDA devices as the cell asks for, and exits with another
code than 0, printing no result, without them. See rtbench/core.py.
"""

import time

T_START = time.perf_counter()  # set-up runs from here

import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "4")

from rtbench import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
