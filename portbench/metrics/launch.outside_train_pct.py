"""The share of the traced window outside the device-side spans of the
program's ``fleet_train`` range: host draws, initial weights, the upload,
the on-device normalization, the normative summary and the fetch."""

LAYER = "fleet launch: train/batched.py launch_many_vaes"
UNIT, SOURCE, MOVES = "%", "program_span", "train_rows_per_s"


def read(ctx):
    s = ctx.trace.range_seconds("fleet_train")
    if not s:
        return None
    return 100.0 * (1.0 - s / ctx.trace.window_s)
