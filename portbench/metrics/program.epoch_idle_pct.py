"""The share of the traced window in which the card waits while the host
submits an epoch (one graph replay: the innermost open span
``program.epoch``)."""

from portbench import program_spans

LAYER = "training program: train/program.py"
UNIT, SOURCE, MOVES = "%", "program_span", "train_rows_per_s"
SPANS = ("program.epoch",)


def read(ctx):
    return program_spans.idle_pct(ctx, SPANS)
