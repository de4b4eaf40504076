"""The fleet's convolution kernels (``ops/csrc/conv1d.cu``) against their
least time: each layer's pass the larger of its FLOPs over the peak and its
bytes over the bandwidth (frozen ``conv_bound_ms``), over every training
step (forward, dx, dw) and every eval forward of the window's jobs, divided
by the device time of the kernels whose names match ``PATTERN``."""

LAYER = "kernel: ops/conv1d.py"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"
PATTERN = (r"(?<![A-Za-z0-9_])(?:conv_fwd_f32|conv_fwd_bf16|conv_wgrad_f32|conv_wgrad_bf16"
           r"|conv_wgrad_finish)(?![A-Za-z0-9_])")


def least_s(ctx) -> float:
    w, c, cost = ctx.work, ctx.config, ctx.cost
    shape = dict(seq_len=c["seq_len"], micro_ch=c["micro_ch"], lesion_ch=c["lesion_ch"],
                 compute=c["compute"])
    T = w["members"]
    ms = w["train_steps"] * cost.conv_bound_ms(T, w["batch"], **shape)["bound_ms"]
    ms += sum(cost.conv_bound_ms(T, r, **shape)["forward"] for r in w["eval_rows"])
    return ctx.jobs * ms / 1e3


def read(ctx):
    kernels = ctx.trace.op_seconds(PATTERN)
    if kernels <= 0:
        return None
    return 100.0 * least_s(ctx) / kernels
