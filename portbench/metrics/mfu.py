"""``mfu.<cell's loop>``: the window's operations, counted from shapes
(``roofline.py``: dense products, 2·nnz·d a sparse product), over the
traced window's wall time at the card's f32 peak of 67 TFLOP/s (TF32 off;
the published rate at 700 W)."""

from portbench import roofline


def read(ctx):
    if ctx.trace is None or ctx.window.units == 0:
        return None
    flops = ctx.cell.work()["flops_per_unit"] * ctx.window.units
    return 100.0 * flops / ctx.window.seconds / roofline.PEAK_F32_FLOPS
