"""Run one cell of the port's benchmark: see harness.py.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1
"""

import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys

    # the checkout's root, not this folder, heads the import path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    from portbench.harness import main

    sys.exit(main(t_start=T0))
