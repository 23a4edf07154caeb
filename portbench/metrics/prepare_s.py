"""``prepare_s``: seconds of the program's graph preparation, the
benchmark's ``prepare`` span (host clock): the trainer's construction and
``prepare_training()``, or TAM's set-up up to its first epoch."""


def read(ctx):
    return ctx.spans.total("prepare") or None
