"""The traced window's share of the card's peak: the convolution and dense
FLOPs its jobs need (every training step's forward, input gradients but of
the two layers that take the data, and weight gradients; every eval
forward and encode), from the frozen counts at the model's own lengths,
over the window and the compute dtype's peak (67 TFLOP/s for float32)."""

LAYER = "training program: train/program.py"
UNIT, SOURCE, MOVES = "%", "device_trace", "train_rows_per_s"


def job_flops(ctx) -> float:
    w, c, cost = ctx.work, ctx.config, ctx.cost
    shape = dict(seq_len=c["seq_len"], micro_ch=c["micro_ch"], lesion_ch=c["lesion_ch"],
                 latent=c["latent"])
    T = w["members"]
    flops = w["train_steps"] * cost.step_flops(T, w["batch"], **shape)
    flops += sum(cost.forward_flops(T, r, **shape) for r in w["eval_rows"])
    flops += sum(cost.forward_flops(T, r, encoder_only=True, **shape) for r in w["encode_rows"])
    return flops


def read(ctx):
    tr = ctx.trace
    if tr.busy_s <= 0:
        return None
    peak = ctx.cost.peak_flops(ctx.config["compute"])
    return 100.0 * ctx.jobs * job_flops(ctx) / (tr.window_s * peak)
