"""The share of the traced window in which no operation runs on the card."""

LAYER = "device: one H100"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"


def read(ctx):
    tr = ctx.trace
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
