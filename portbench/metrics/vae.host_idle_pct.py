"""The share of the traced window in which the card waits on the single
trainer's host work around its program: the module's init and the draws,
their upload, the program's copy-in and the history's read (the innermost
open span one of ``SPANS``)."""

from portbench import program_spans

LAYER = "VAE stage: train/trainer.py train_lesion_vae"
UNIT, SOURCE, MOVES = "%", "program_span", "train_rows_per_s"
SPANS = ("vae.init", "vae.upload", "program.load", "program.history")


def read(ctx):
    return program_spans.idle_pct(ctx, SPANS)
