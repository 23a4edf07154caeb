"""``k1_roofline.<cell's loop>``: K1's device time in the traced window,
by kernel name (``csr_spmm_kernel``, which both of its routes carry),
against the least time of the launches the window made, counted by the
program's counter (``bcsr_spmm.launches``), four an epoch
(``Cell.k1_least_s``: bytes once at the HBM rate or operations at the
f32 peak, over the members' stored entries)."""

import sys

K1_SYMBOL = "csr_spmm_kernel"


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "k1_least_s"):
        return None
    seconds, count = ctx.trace.device_time(K1_SYMBOL)
    launches = getattr(ctx.cell, "k1_launches", 0)
    if count == 0 or launches == 0:
        return None
    if count != launches:
        print(f"k1_roofline: the trace holds {count} K1 launches, the "
              f"program counted {launches}", file=sys.stderr)
    return 100.0 * ctx.cell.k1_least_s() * launches / 4 / seconds
