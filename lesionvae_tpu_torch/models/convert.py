"""Carry the JAX package's VAE weights into the port's model.

``from_jax_params`` takes the flax ``params`` and ``batch_stats`` trees as
numpy arrays (the JAX package's TrainedVAE holds them) and returns a
``state_dict`` for ``LesionConditionedVAE``:
- Conv kernel (k, in, out) -> weight (out, in, k);
- ConvTranspose: the JAX model runs it as a convolution with the kernel
  flipped, (k, in, out) -> (in, out, k) reversed along k;
- the dense layers next to a flatten: the JAX model flattens l-major
  (l*C + c), the port channel-major (c*L + l), so the columns of
  fc_mu/fc_logv and the rows, bias and lesion-context columns of fc_dec
  are permuted.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CONVS = ("micro_c1", "micro_c2", "micro_c3", "lesion_c1", "lesion_c2")
_CONV_TS = ("dec_t1", "dec_t2", "dec_t3")
_BNS = ("micro_b1", "micro_b2", "micro_b3", "lesion_b1", "lesion_b2",
        "dec_b1", "dec_b2")


def _flat_perm(L: int, C: int) -> np.ndarray:
    """Index j of the l-major flatten (j = l*C + c) -> its index in the
    channel-major flatten (c*L + l)."""
    j = np.arange(L * C)
    return (j % C) * L + j // C


def from_jax_params(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """The flax trees of a LesionConditionedVAE -> the port's state_dict.
    Arrays keep their dtype."""
    a = lambda x: np.asarray(x)  # noqa: E731
    sd: Dict[str, np.ndarray] = {}
    for name in _CONVS:
        sd[f"{name}.weight"] = a(params[name]["conv"]["kernel"]).transpose(2, 1, 0)
        sd[f"{name}.bias"] = a(params[name]["conv"]["bias"])
    for name in _CONV_TS:
        sd[f"{name}.weight"] = a(params[name]["conv"]["kernel"]).transpose(1, 2, 0)[:, :, ::-1]
        sd[f"{name}.bias"] = a(params[name]["conv"]["bias"])
    for name in _BNS:
        sd[f"{name}.weight"] = a(params[name]["scale"])
        sd[f"{name}.bias"] = a(params[name]["bias"])
        sd[f"{name}.running_mean"] = a(batch_stats[name]["mean"])
        sd[f"{name}.running_var"] = a(batch_stats[name]["var"])

    # flatten widths from the convolutions' output channels and the dense
    # layers' shapes: micro (L/8, 128), lesion (L/4, 64)
    ch_m = sd["micro_c3.bias"].shape[0]
    ch_l = sd["lesion_c2.bias"].shape[0]
    k_dec = a(params["fc_dec"]["dense"]["kernel"])        # (latent + lesion_out, micro_out)
    Lm = k_dec.shape[1] // ch_m
    k_mu = a(params["fc_mu"]["dense"]["kernel"])          # (micro_out + lesion_out, latent)
    Ll = (k_mu.shape[0] - Lm * ch_m) // ch_l
    pm, pl = _flat_perm(Lm, ch_m), _flat_perm(Ll, ch_l)
    enc_cols = np.concatenate([pm, Lm * ch_m + pl])
    for name in ("fc_mu", "fc_logv"):
        k = a(params[name]["dense"]["kernel"])
        w = np.empty((k.shape[1], k.shape[0]), k.dtype)
        w[:, enc_cols] = k.T
        sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = a(params[name]["dense"]["bias"])
    latent = k_dec.shape[0] - Ll * ch_l
    dec_cols = np.concatenate([np.arange(latent), latent + pl])
    w = np.empty((k_dec.shape[1], k_dec.shape[0]), k_dec.dtype)
    w[pm[:, None], dec_cols[None, :]] = k_dec.T
    b = np.empty(k_dec.shape[1], k_dec.dtype)
    b[pm] = a(params["fc_dec"]["dense"]["bias"])
    sd["fc_dec.weight"], sd["fc_dec.bias"] = w, b
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
