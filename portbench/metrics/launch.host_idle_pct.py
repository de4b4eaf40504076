"""The share of the traced window in which the card waits on the fleet
launch's host work: the members' initial weights built on the CPU, the
draws, the upload of the blocks, the on-device normalization's launches,
the stacked state and the program's copy-in (the innermost open span one of
``SPANS``)."""

from portbench import program_spans

LAYER = "fleet launch: train/batched.py launch_many_vaes"
UNIT, SOURCE, MOVES = "%", "program_span", "train_rows_per_s"
SPANS = ("fleet.init", "fleet.draws", "fleet.upload", "fleet.normalize", "fleet.state",
         "program.load")


def read(ctx):
    return program_spans.idle_pct(ctx, SPANS)
