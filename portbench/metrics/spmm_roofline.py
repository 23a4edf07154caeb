"""``spmm_roofline.<cell's loop>``: ``ops.spmm.spmm(trainer.adj, H)`` at
the cell's width, timed alone after the window with CUDA events, against
its least time: the larger of 2·nnz·d at the f32 peak and its bytes at
the HBM rate, nnz counted from the normalised graph (Â = norm(A) + I),
not from the layout the route stores, so it reads the same work whatever
the route."""

import torch

from portbench import roofline, weights


def read(ctx):
    if (ctx.trace is None or not hasattr(ctx.cell, "spmm_call")
            or ctx.cell.device.type != "cuda"):
        return None
    w = ctx.cell.work()
    n, d, nnz = w["n"], w["d"], w["nnz"]
    dev = ctx.cell.device
    h = torch.randn(n, d, generator=weights.generator(ctx.seed, 3, dev),
                    device=dev)
    with torch.no_grad():
        ms = roofline.event_ms(ctx.cell.spmm_call(h))
    return 100.0 * roofline.spmm_least_s(nnz, n, n, d) * 1e3 / ms
