"""``ell_residual_ms.<cell's loop>``: the card's time a step or request in
the ELL tables' chunked COO residual: the stream time inside each
``ell.residual`` span the program kept in the traced window (one a
residual pass, products and affinities, forward and backward), over the
window's ``step`` or ``score`` spans (``program_spans.py``). None where
the program keeps no spans or its route has no residual."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_unit_ms(
        program_spans.window_spans(ctx), "ell.residual")
