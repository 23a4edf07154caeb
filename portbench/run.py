"""Entry point of the port's benchmark (see ``harness.py``):

    python3 portbench/run.py --workload tfinance.train --seed 7 \
        --seconds 10 --trace 0

run from the root of a checkout. The last line of standard output is the
run's result as one JSON object; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this directory, heads the import path
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
