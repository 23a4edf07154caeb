"""``spmm_ms.<cell's loop>``: the card's time a step or request in the
program's sparse products: the stream time inside each outermost ``spmm``
span the program kept in the traced window (``ops.spmm.spmm`` on every
route, and the backward of the tile and table products), over the
window's ``step`` or ``score`` spans (``program_spans.py``). None where
the program keeps no spans."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_unit_ms(
        program_spans.window_spans(ctx), "spmm")
