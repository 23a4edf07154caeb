"""``copy_ms.<cell's loop>``: the median over the traced window's requests
of the time from the end of a request's ``score.forward`` on the card's
stream to the end of its ``score.copy`` span (the scores copied to a host
array), from the CUDA events of the program's spans
(``program_spans.py``). None where the program keeps no spans."""

from portbench import program_spans


def read(ctx):
    return program_spans.copy_ms(program_spans.window_spans(ctx))
