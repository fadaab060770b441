"""The benchmark of ``walnuts_tpu_torch`` on CUDA devices.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the run's metrics, the device, and
whether the window's outputs agree with the plain reference, as one JSON
object on the last line of standard output (``harness/main.py``).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# packages are found from the checkout's root, not from this directory
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
