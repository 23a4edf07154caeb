"""``tam_epoch_ms``: the TAM window's wall time over the epochs completed
in it (host clock; the window ends when the card has finished the last
epoch)."""


def read(ctx):
    return 1e3 * ctx.window.seconds / ctx.window.units
