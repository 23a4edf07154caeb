"""The program's spans over one cell's window, outside the benchmark's runs:

    python3 portbench/span_report.py --workload tfinance.train --seed 7 \
        --seconds 20 [--out spans.json]
    python3 portbench/span_report.py --workload tfinance.score --seed 7 \
        --seconds 5 --cost 4

run from the root of a checkout. The first form sets the cell up as a run
does, with the program's tracing on from the start, runs the window under
a profiler that records the card alone and prints one JSON object: each
device operation put down to the program span open at its launch
(``span_attribution.py``), the spans by path (count, host seconds, device
seconds, set-up host seconds), the idle gaps by span path, the share of
operations linked to their launch and of device time put down to a
program span, the ELL counters' change over the window, and the readers'
values from the spans' CUDA events beside those from the launches.

``--cost R`` instead measures what tracing costs with no profiler: R
rounds of a window with tracing off and one with it on, in turns, and
the cell's end-to-end metric of each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import harness, program_spans, span_attribution  # noqa: E402
from portbench.tracing import Spans, Trace  # noqa: E402


def counters() -> dict:
    from ggad_tpu_torch.ops.bcsr_sddmm import bcsr_sddmm_colsum
    from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm
    from ggad_tpu_torch.ops.ell_spmm import ell_spmm

    out = {f"ell_spmm.{k}": getattr(ell_spmm, k)
           for k in ("bucket_slots", "residual_entries", "residual_chunks")}
    out["bcsr_spmm.launches"] = bcsr_spmm.launches
    out["bcsr_sddmm_colsum.launches"] = bcsr_sddmm_colsum.launches
    return out


def end_to_end_ms(win) -> float:
    """The cell's end-to-end metric, read by its reader."""
    name = "train_step_ms" if win.latencies_s is None else "score_p95_ms"
    return harness.reader(name).read(harness.Context(
        seed=0, cell=None, spans=None, setup_s=0.0, window=win))


def make_cell(args, spans):
    import torch

    spec = harness.load_spec(args.root)
    wl, cfg, traffic, _ = harness.cell_files(spec, args.workload, args.root)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    drv = importlib.import_module(f"portbench.drivers.{cfg['model']}")
    cell = drv.Cell(cfg, traffic, args.device, spans)
    cell.start(args.seed)
    sync(args.device)
    return cell


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def trace(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ggad_tpu_torch.utils import tracing

    on_card = torch.device(args.device).type == "cuda"
    spans = Spans(traced=True)
    tracing.enable()
    cell = make_cell(args, spans)
    setup = tracing.collect()
    before = counters()
    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.start()
    with spans("window"):
        win = cell.window(args.seconds)
    prof.stop()
    after = counters()
    program = tracing.collect()
    tracing.disable()
    window = next((a, b) for n, a, b in spans.wall if n == "window")
    ops, launches = span_attribution.kineto(prof)
    out = span_attribution.breakdown(ops, launches, program, spans.wall,
                                     window, setup)
    inside = [s for s in program if window[0] <= s.start_ns <= window[1]]
    out["events"] = {
        "spmm_ms": program_spans.per_unit_ms(inside, "spmm"),
        "ell_residual_ms": program_spans.per_unit_ms(inside,
                                                     "ell.residual"),
        "copy_ms": program_spans.copy_ms(inside)}
    if ops:
        t = Trace(prof, spans)
        out["benchmark"] = {"busy_s": t.busy_s, "window_s": t.window_s,
                            "idle_gaps": t.idle_gaps(),
                            "device_ops": t.top_ops()}
    out["counters"] = {k: after[k] - before[k] for k in after}
    out.update(workload=args.workload, seed=args.seed, units=win.units,
               window_s=win.seconds, metric_ms=end_to_end_ms(win),
               device=(torch.cuda.get_device_name(args.device) if on_card
                       else "cpu"))
    return out


def cost(args) -> dict:
    from ggad_tpu_torch.utils import tracing

    cell = make_cell(args, Spans())
    rows = {"off": [], "on": []}
    for r in range(args.cost):
        order = ("off", "on") if r % 2 == 0 else ("on", "off")
        for mode in order:
            if mode == "on":
                tracing.enable()
            win = cell.window(args.seconds)
            tracing.disable()
            kept = len(tracing.collect())
            rows[mode].append(end_to_end_ms(win))
            print(f"round {r} tracing {mode}: {rows[mode][-1]:.4f} ms, "
                  f"{win.units} units, {kept} spans", file=sys.stderr,
                  flush=True)
    off, on = statistics.median(rows["off"]), statistics.median(rows["on"])
    return {"workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "off_ms": rows["off"],
            "on_ms": rows["on"], "median_off_ms": off, "median_on_ms": on,
            "cost_ms": on - off, "cost_pct": 100.0 * (on - off) / off}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--cost", type=int, default=0,
                   help="rounds of tracing off / on, with no profiler")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--root", type=Path, default=harness.PB.parent)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    out = cost(args) if args.cost else trace(args)
    out["script_s"] = time.perf_counter() - t0
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
