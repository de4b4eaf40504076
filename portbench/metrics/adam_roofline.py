"""The optimizer's kernels (``ops/csrc/adam.cu``: the gradient gather with
each member's norm, and the float32 update) against their least bytes
(frozen ``optimizer_bytes``: every gradient element read and written once
by the gather; g, p, m, v read and p, m, v written once by the update) a
training step, over the bandwidth, divided by the device time of the
kernels whose names match ``PATTERN``.  With bfloat16 storage the update
here is the BatchNorm leaves' alone: the weights' runs in
``sr_adam_kernel`` (``sr_adam_roofline``)."""

LAYER = "kernel: ops/adam.py"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"
PATTERN = (r"(?<![A-Za-z0-9_])(?:norm_tiles_kernel|norm_finish_kernel|adam_kernel)"
           r"(?![A-Za-z0-9_])")


def least_s(ctx) -> float:
    w, c, cost = ctx.work, ctx.config, ctx.cost
    if w["flat_params"]:
        per = cost.flat_optimizer_bytes(cost.parameters(c["seq_len"], c["micro_ch"],
                                                        c["lesion_ch"], c["latent"])["total"])
    else:
        per = cost.optimizer_bytes(w["members"], c["seq_len"], c["micro_ch"], c["lesion_ch"],
                                   c["latent"], c["storage"])
    update = per["update_affine"] if c["storage"] == "bfloat16" else per["optimizer"]
    nbytes = ctx.jobs * w["train_steps"] * (per["grad_sq_norm"] + update)
    return nbytes / cost.HBM_BYTES_PER_S


def read(ctx):
    kernels = ctx.trace.op_seconds(PATTERN)
    if kernels <= 0:
        return None
    return 100.0 * least_s(ctx) / kernels
