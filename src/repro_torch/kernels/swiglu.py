"""SwiGLU activation: the wrapper around ``csrc/swiglu.cu`` and its plain
version.

Replaces the TPU kernel ``repro/kernels/swiglu.py:swiglu``: ``silu(g) * u``
in f32, cast back.  ``silu(g)`` is not rounded before the product, as in the
TPU kernel and ``kernels/ref.py``; the JAX trunk (``layers.py``, ffn_block)
rounds it to the model dtype first, which differs by about one ulp in bf16
and agrees at f32.  Bound by bytes on the H100: see ``csrc/swiglu.cu``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from repro_torch.kernels import (
    INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn, on_cpu, stream_ptr,
)


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (F_.silu(g.float()) * u.float()).to(g.dtype)


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g, u: (..., f) of one shape and dtype.  Plain version on the CPU,
    the kernel on CUDA."""
    if on_cpu(g, u):
        return swiglu_plain(g, u)
    if g.shape != u.shape:
        raise ValueError(f"g {tuple(g.shape)} and u {tuple(u.shape)} differ")
    check_operand(g, "g")
    check_operand(u, "u", g.dtype)
    code = dtype_code(g)
    out = torch.empty_like(g)
    vec = int(aligned16(g, u, out))
    fn = kernel_fn("swiglu", "swiglu_launch", [PTR, PTR, PTR, ctypes.c_longlong, INT, INT, PTR])
    err = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), code, vec,
             stream_ptr(g))
    check_launch("swiglu", err)
    swiglu.launches += 1
    return out


swiglu.launches = 0
