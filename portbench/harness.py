"""One run of one cell of ``BENCHMARK.json``:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (the graph, the program's preparation, the seed's weights, the
first steps, which warm every shape) is timed from the process's start
to the window's. The window runs the traffic's loop for ``--seconds``.
With ``--trace 0`` the cell's end-to-end metrics are read; with
``--trace 1`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are read. Then the peak memory is read, the program's
state freed, and what the window's path produced is compared with the
plain reference (``checks/<workload>.json`` holds each number's limit).

Everything belonging to one configuration, traffic mix or metric is a
file found by its name: ``configs/<config>.json`` (through
``BENCHMARK.json``'s ``file``), ``traffic/<traffic>.json``,
``checks/<workload>.json``, ``drivers/<model>.py`` and
``metrics/<metric>.py`` (or ``metrics/<name before the first dot>.py``).
A cell kept out of ``BENCHMARK.json`` waits in ``ready/<workload>.json``
with the entries that add it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Optional

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ggad_tpu")


class Refused(Exception):
    """A run that must print no result (exit code in ``code``)."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    seed: int
    cell: Any
    spans: Any
    setup_s: float
    window: Any
    trace: Any = None


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise Refused(2, f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(spec: dict, workload: str, root: Path) -> tuple:
    """(workload entry, configuration, traffic, limits) of a cell, each
    read from its own file."""
    wl = find(spec["workloads"], workload, "workload")
    entry = find(spec["configs"], wl["config"], "configuration")
    cfg = json.loads((root / entry["file"]).read_text())
    cfg["name"] = entry["name"]
    traffic = json.loads((PB / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits = json.loads((PB / "checks" / f"{wl['name']}.json").read_text())
    return wl, cfg, traffic, limits


def cell_metrics(spec: dict, workload: str, traced: bool) -> list:
    """The metrics this cell reports: its per-layer ones in a traced run,
    its end-to-end ones otherwise."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``, else ``metrics/<prefix>.py`` for a name
    ``<prefix>.<suffix>``: the module whose ``read(ctx)`` gives the
    metric, or None where it finds nothing to read."""
    for stem in (name, name.split(".")[0]):
        path = PB / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise Refused(2, f"no reader for metric {name!r} in {PB / 'metrics'}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(argv: Optional[list] = None, *, root: Optional[Path] = None,
        device: Optional[str] = None,
        t_start: Optional[float] = None) -> tuple[dict, list]:
    """One run; returns (the result line's object, the check lines).
    ``device`` is for tests on the host: a run without it needs the
    card."""
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = root or PB.parent
    spec = load_spec(root)
    wl, cfg, traffic, limits = cell_files(spec, args.workload, root)
    traced = bool(args.trace)

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused(3, "no CUDA device: this benchmark measures the "
                             "card")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise Refused(3, f"{wl['name']} needs {wl['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        device = "cuda:0"
    from portbench import reference
    from portbench.tracing import Spans, Trace

    # the program runs as its configuration states; the reference, later,
    # always in f32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    drv = importlib.import_module(f"portbench.drivers.{cfg['model']}")
    spans = Spans(traced=traced)
    cell = drv.Cell(cfg, traffic, device, spans)
    cell.start(args.seed)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])
        prof.start()
    with spans("window"):
        win = cell.window(args.seconds)
    trace = None
    if prof is not None:
        prof.stop()
        trace = Trace(prof, spans)
        del prof
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": int(wl["chips"]),
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if on_card else 0)}

    ctx = Context(seed=args.seed, cell=cell, spans=spans, setup_s=setup_s,
                  window=win, trace=trace)
    metrics = {}
    for m in cell_metrics(spec, wl["name"], traced):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": False, "attempted": win.units,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace is not None:
        if trace.busy_s <= 0:
            raise Refused(5, "the profiler saw no device activity in the "
                             "window")
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}

    produced = cell.produced()
    cell.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference.set_f32()
    numbers = cell.gaps(produced, cell.readings(cell.reference()))
    checks = {k: {"value": numbers.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    result["correct"] = all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
             for k, c in checks.items()]
    return result, lines


def main(argv: Optional[list] = None, t_start: Optional[float] = None
         ) -> int:
    try:
        result, lines = run(argv, t_start=t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; the "
              f"port's benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
