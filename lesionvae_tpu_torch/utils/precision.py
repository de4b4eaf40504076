"""Full float32 arithmetic on the card."""

from __future__ import annotations

import torch


def full_fp32(device) -> None:
    """Float32 products and convolutions on a CUDA device stay float32.

    cuDNN's convolutions default to TF32, which keeps about three decimal
    digits: the VAE's results would part from the CPU's, and the lesion
    stage's SH fit and its Pearson r need float32.  Every entry point that
    runs float32 work on the card calls this first."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
