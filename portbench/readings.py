"""The readings that the limits in ``checks/`` are set from, at a cell's
own size on the card, in one process (the benchmark's runs never call
this):

    python3 portbench/readings.py --workload tfinance.train \
        --seeds 101,102,... --control 3 --faults 3 [--seconds 2]

For each seed it starts the cell as a run does and prints one JSON line
of the numbers its timed path gives against the plain reference
(``program``; a scoring cell serves ``--seconds`` of requests first). On
the first ``--control`` seeds it also prints the control's: the
reference in TF32 put in the program's place (``control``), and on the
first ``--faults`` seeds of a training cell the reference with half of
its batch left out (``fault:half_batch``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import harness, reference  # noqa: E402
from portbench.tracing import Spans  # noqa: E402


def main(argv=None, *, device: str | None = None, root=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    root = root or harness.PB.parent
    spec = harness.load_spec(root)
    wl, cfg, traffic, limits = harness.cell_files(spec, args.workload, root)
    device = device or "cuda:0"
    reference.set_f32()
    drv = importlib.import_module(f"portbench.drivers.{cfg['model']}")
    cell = drv.Cell(cfg, traffic, device, Spans())
    ref = cell.reference()
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell.start(seed)
        if traffic["loop"] == "score":
            cell.window(args.seconds)
        base = cell.readings(ref)
        rows = [("program", cell.gaps(cell.produced(), base))]
        if i < args.control:
            ctrl = cell.readings(ref, "tf32")
            rows.append(("control", cell.gaps(
                [ctrl] if traffic["loop"] == "score" else ctrl, base)))
        if i < args.faults and traffic["loop"] == "train":
            rows.append(("fault:half_batch", cell.gaps(
                cell.readings(ref, fault="half_batch"), base)))
        for what, numbers in rows:
            print(json.dumps({"workload": wl["name"], "seed": seed,
                              "what": what, **numbers,
                              "limits": limits}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
