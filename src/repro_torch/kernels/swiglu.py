"""SwiGLU activation: the wrapper around ``csrc/swiglu.cu`` and its plain
version.

Replaces the TPU kernel ``repro/kernels/swiglu.py:swiglu``: ``silu(g) * u``
in f32, cast back.  ``silu(g)`` is not rounded before the product, as in the
TPU kernel and ``kernels/ref.py``; the JAX trunk (``layers.py``, ffn_block)
rounds it to the model dtype first, which differs by about one ulp in bf16
and agrees at f32.  Bound by bytes on the H100: see ``csrc/swiglu.cu``.

Under grad the kernel runs inside :class:`SwiGLUFn`, whose backward
recomputes the plain version and differentiates it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from repro_torch.kernels import (
    INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn, needs_grad,
    recompute_grads, refuse_detach, runs_plain, stream_ptr,
)


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (F_.silu(g.float()) * u.float()).to(g.dtype)


def swiglu_launch(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad)."""
    refuse_detach("swiglu", g, u)
    if g.shape != u.shape:
        raise ValueError(f"g {tuple(g.shape)} and u {tuple(u.shape)} differ")
    check_operand(g, "g")
    check_operand(u, "u", g.dtype)
    code = dtype_code(g)
    out = torch.empty_like(g)
    if out.numel() == 0:  # a zero-width FFN: nothing to launch (an empty grid is invalid)
        return out
    vec = int(aligned16(g, u, out))
    fn = kernel_fn("swiglu", "swiglu_launch", [PTR, PTR, PTR, ctypes.c_longlong, INT, INT, PTR])
    err = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), code, vec,
             stream_ptr(g))
    check_launch("swiglu", err)
    swiglu.launches += 1
    return out


class SwiGLUFn(torch.autograd.Function):
    """Kernel forward (or the plain version, where :func:`runs_plain`);
    backward through the recomputed plain version."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        if runs_plain(g, u):
            return swiglu_plain(g, u)
        return swiglu_launch(g, u)

    @staticmethod
    def backward(ctx, dy):
        return recompute_grads(swiglu_plain, ctx.saved_tensors, ctx.needs_input_grad, dy)


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g, u: (..., f) of one shape and dtype.  Plain version on the CPU,
    the kernel on CUDA (through :class:`SwiGLUFn` when autograd records)."""
    if runs_plain(g, u):
        return swiglu_plain(g, u)
    if needs_grad(g, u):
        return SwiGLUFn.apply(g, u)
    return swiglu_launch(g, u)


swiglu.launches = 0
