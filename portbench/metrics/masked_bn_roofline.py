"""The fleet's masked BatchNorm + ReLU kernels (``ops/csrc/masked_bn.cu``)
against their least bytes (frozen ``masked_bn_bytes``: each training step's
forward and backward, each eval forward's apply) over the bandwidth,
divided by the device time of the kernels whose names match ``PATTERN``."""

LAYER = "kernel: ops/masked_bn.py"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"
PATTERN = (r"(?<![A-Za-z0-9_])(?:cluster_forward_kernel|cluster_backward_kernel|stats_kernel"
           r"|apply_kernel|grad_sums_kernel|grad_apply_kernel)(?![A-Za-z0-9_])")


def least_s(ctx) -> float:
    w, c, cost = ctx.work, ctx.config, ctx.cost
    T = w["members"]
    step = cost.masked_bn_bytes(T, w["batch"], c["seq_len"], c["compute"])
    nbytes = w["train_steps"] * (step["forward_bytes"] + step["backward_bytes"])
    nbytes += sum(cost.masked_bn_bytes(T, r, c["seq_len"], c["compute"])["forward_bytes"]
                  for r in w["eval_rows"])
    return ctx.jobs * nbytes / cost.HBM_BYTES_PER_S


def read(ctx):
    kernels = ctx.trace.op_seconds(PATTERN)
    if kernels <= 0:
        return None
    return 100.0 * least_s(ctx) / kernels
