"""``train_step_ms``: the training window's wall time over the steps
completed in it, the loss reads included (host clock; the window ends on
a read, so on the card's last step)."""


def read(ctx):
    return 1e3 * ctx.window.seconds / ctx.window.units
