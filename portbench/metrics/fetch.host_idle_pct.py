"""The share of the traced window in which the card waits on the fleet's
fetch: the history's read (where the host waits for the card) and the
trained members built as modules on the CPU (the innermost open span one of
``SPANS``)."""

from portbench import program_spans

LAYER = "fleet launch: train/batched.py launch_many_vaes"
UNIT, SOURCE, MOVES = "%", "program_span", "train_rows_per_s"
SPANS = ("fetch.history", "fetch.members")


def read(ctx):
    return program_spans.idle_pct(ctx, SPANS)
