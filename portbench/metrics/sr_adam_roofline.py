"""The bfloat16 store's update (``ops/csrc/sr_adam.cu``, ``sr_adam_kernel``:
clip -> decay -> Adam on the weight leaves, written back with stochastic
rounding) against its least bytes (frozen ``optimizer_bytes`` with bfloat16
storage, ``update_weights``: p, m, v read and written and g read, 14 B an
element; the members' shared index table, served from L2, not counted) a
training step, over the bandwidth, divided by the device time of the
kernels whose names match ``PATTERN``.  Float32 storage runs no such
kernel: nothing to read."""

LAYER = "kernel: ops/sr_adam.py"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"
PATTERN = r"(?<![A-Za-z0-9_])sr_adam_kernel(?![A-Za-z0-9_])"


def least_s(ctx) -> float:
    w, c, cost = ctx.work, ctx.config, ctx.cost
    per = cost.optimizer_bytes(w["members"], c["seq_len"], c["micro_ch"], c["lesion_ch"],
                               c["latent"], "bfloat16")
    return ctx.jobs * w["train_steps"] * per["update_weights"] / cost.HBM_BYTES_PER_S


def read(ctx):
    if ctx.config["storage"] != "bfloat16":
        return None
    kernels = ctx.trace.op_seconds(PATTERN)
    if kernels <= 0:
        return None
    return 100.0 * least_s(ctx) / kernels
