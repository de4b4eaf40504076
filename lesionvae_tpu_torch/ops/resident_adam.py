"""K resident Adam steps on bf16-stored p/m/v: the CUDA kernel and its plain
version.

    g = GA*p + c;  m' = B1*m + (1-B1)*g;  v' = B2*v + (1-B2)*g*g
    p' = p - LR*(m' / (sqrt(v') + EPS))         form "ieee" (the default)
    p' = p - (LR*m') * rsqrt(v' + EPS*EPS)      form "fastmath"
    p', m', v' rounded to bf16 each step

This is the synthetic-gradient optimizer pass of the optimizer probe
(``benchmarks/opt_probe.py``); the fast-math form is the JAX probe's
``PROBE_FASTMATH`` switch (pallas_opt_probe.py:83-85, :95-96), which asks how
much of a resident step is the divide/sqrt chain.  ``resident_adam`` is the
entry point: on CUDA tensors it launches the hand-written Hopper kernel
``csrc/resident_adam.cu`` (which replaces
``benchmarks/pallas_opt_probe.py::_resident_kernel``) and raises on inputs the
kernel does not take; on CPU tensors it computes ``resident_adam_plain``.
There is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .cuda_build import load

# The probe's constants (pallas_opt_probe.py:81-82), as the float32 values
# that both the kernel and the plain version compute with.  The complements
# are rounded from the float64 difference, as a framework does when it
# multiplies a float32 array by the Python float ``1 - B1``.
_B1, _B2 = 0.9, 0.999
GA = float(np.float32(0.999))
B1 = float(np.float32(_B1))
ONE_MINUS_B1 = float(np.float32(1 - _B1))
B2 = float(np.float32(_B2))
ONE_MINUS_B2 = float(np.float32(1 - _B2))
LR = float(np.float32(2e-4))
EPS = float(np.float32(1e-8))
# the fast-math form's EPS*EPS: the product of the Python floats, rounded once
EPS2 = float(np.float32(1e-8 * 1e-8))
FORMS = ("ieee", "fastmath")


def _check_form(form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"resident Adam takes form 'ieee' or 'fastmath', got {form!r}")


def resident_adam_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        k: int, c: float, form: str = "ieee"):
    """Plain PyTorch K-step loop (the body of ``run_xla``,
    pallas_opt_probe.py:102-115): every step reads and writes p/m/v in their
    storage dtype.  Returns new (p, m, v); the inputs are not modified."""
    _check_form(form)
    c = float(np.float32(c))
    for _ in range(int(k)):
        p32, m32, v32 = p.float(), m.float(), v.float()
        g = GA * p32 + c
        m2 = B1 * m32 + ONE_MINUS_B1 * g
        v2 = B2 * v32 + ONE_MINUS_B2 * g * g
        if form == "fastmath":
            p2 = p32 - LR * m2 * torch.rsqrt(v2 + EPS2)
        else:
            p2 = p32 - LR * (m2 / (torch.sqrt(v2) + EPS))
        p, m, v = p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)
    return p, m, v


def _check(p, m, v) -> None:
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"resident Adam kernel takes {name} as bfloat16, "
                            f"got {t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"resident Adam kernel takes a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"resident Adam kernel takes {name} aligned to "
                             "16 bytes (it loads 8 bf16 at a time)")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/resident_adam.cu, built on first use."""
    fn = load("resident_adam").lesionvae_resident_adam
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int]
                   + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(p, m, v, k: int, c: float, form: str):
    _check(p, m, v)
    if k < 0:
        raise ValueError(f"resident Adam takes k >= 0, got {k}")
    fn = _kernel()
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in (p, m, v)]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 *(o.data_ptr() for o in outs), p.numel(), int(k),
                 int(form == "fastmath"), float(np.float32(c)), GA, B1,
                 ONE_MINUS_B1, B2, ONE_MINUS_B2, LR, EPS, EPS2, stream)
    if err != 0:
        raise RuntimeError(f"resident Adam kernel launch failed: cudaError {err}")
    resident_adam.launches += 1
    return tuple(outs)


def resident_adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                  k: int, c: float, form: str = "ieee"):
    """K Adam steps with synthetic gradient ``GA*p + c``, out of place, in
    the IEEE form or the fast-math form.  CUDA tensors: the kernel (bf16,
    contiguous, same shape and device), counted in
    ``resident_adam.launches``.  CPU tensors: ``resident_adam_plain``."""
    _check_form(form)
    if p.device.type == "cpu":
        return resident_adam_plain(p, m, v, k, c, form)
    if p.device.type != "cuda":
        raise ValueError(f"resident Adam runs on cuda or cpu, not {p.device}")
    return _launch(p, m, v, k, c, form)


# launches of the kernel in this process; a run sets it to 0 and reads it back
# to show its path went through the kernel
resident_adam.launches = 0
