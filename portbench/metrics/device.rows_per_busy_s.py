"""The rows the traced window's jobs trained over the seconds in which an
operation ran on the card: the rate with the host's gaps left out, steadier
from process to process than ``train_rows_per_s``."""

LAYER = "device: one H100"
UNIT, SOURCE, MOVES = "rows/s", "device_trace", "train_rows_per_s"


def read(ctx):
    tr = ctx.trace
    if tr.busy_s <= 0:
        return None
    return ctx.rows * ctx.jobs / tr.busy_s
