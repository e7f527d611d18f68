"""SwiGLU activation: the wrappers around ``csrc/swiglu.cu`` (forward and
backward) and their plain versions.

Replaces the TPU kernel ``repro/kernels/swiglu.py:swiglu`` and its
gradient.  Two arithmetics, picked by ``round_silu``:

- ``False``, the TPU kernel's (and ``kernels/ref.py``'s): ``silu(g) * u``
  in f32, cast back once.
- ``True``, the JAX trunk's (``models/layers.py`` ffn_block and
  ``models/moe.py`` experts, ``silu(g.astype(f32)).astype(u.dtype) * u``):
  ``silu(g)`` rounded to the model dtype first.  The port's model path
  takes this one.  In bf16 the two differ in about a quarter of the
  outputs; at f32 they agree.

Bound by bytes on the H100: see ``csrc/swiglu.cu``.  Under grad the kernel
runs inside :class:`SwiGLUFn`, whose backward is the ``swiglu_bwd`` kernel
(its plain version :func:`swiglu_bwd_plain` on the CPU).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_

from repro_torch.kernels import (
    INT, PTR, aligned16, book, check_launch, check_operand, dtype_code, kernel_fn,
    needs_grad, on_meta, refuse_detach, runs_plain, stream_ptr,
)


def swiglu_plain(g: torch.Tensor, u: torch.Tensor, round_silu: bool = False) -> torch.Tensor:
    s = F_.silu(g.float())
    if round_silu:
        s = s.to(g.dtype).float()
    return (s * u.float()).to(g.dtype)


def swiglu_bwd_plain(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                     round_silu: bool = False) -> tuple:
    """(dg, du) of :func:`swiglu_plain` at ``dy``: autograd's roundings
    written out, with silu' as PyTorch's ``silu_backward``."""
    gf, uf, dyf = g.float(), u.float(), dy.float()
    s, t = F_.silu(gf), dyf * uf
    if round_silu:
        s, t = s.to(g.dtype).float(), t.to(g.dtype).float()
    return torch.ops.aten.silu_backward(t, gf).to(g.dtype), (dyf * s).to(g.dtype)


def swiglu_launch(g: torch.Tensor, u: torch.Tensor, *, round_silu: bool = False) -> torch.Tensor:
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
    if not on_meta(g):
        fn = kernel_fn("swiglu", "swiglu_launch",
                       [PTR, PTR, PTR, ctypes.c_longlong, INT, INT, INT, PTR])
        err = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), code,
                 int(aligned16(g, u, out)), int(round_silu), stream_ptr(g))
        check_launch("swiglu", err)
        swiglu.launches += 1
    book("swiglu", lambda: (5.0 * g.numel(), 3 * g.numel() * g.element_size()))
    return out


def swiglu_bwd_launch(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                      round_silu: bool = False) -> tuple:
    """The backward kernel: (dg, du) from g, u and dy in one pass."""
    if not (g.shape == u.shape == dy.shape):
        raise ValueError(f"g {tuple(g.shape)}, u {tuple(u.shape)} and dy {tuple(dy.shape)} "
                         "differ")
    check_operand(g, "g")
    check_operand(u, "u", g.dtype)
    check_operand(dy, "dy", g.dtype)
    code = dtype_code(g)
    dg, du = torch.empty_like(g), torch.empty_like(g)
    if g.numel() == 0:
        return dg, du
    if not on_meta(g):
        fn = kernel_fn("swiglu", "swiglu_bwd_launch",
                       [PTR, PTR, PTR, PTR, PTR, ctypes.c_longlong, INT, INT, INT, PTR])
        err = fn(g.data_ptr(), u.data_ptr(), dy.data_ptr(), dg.data_ptr(), du.data_ptr(),
                 g.numel(), code, int(aligned16(g, u, dy, dg, du)), int(round_silu),
                 stream_ptr(g))
        check_launch("swiglu", err, "swiglu_bwd")
        swiglu_bwd.launches += 1
    book("swiglu_bwd",
         lambda: (20.0 * g.numel(), 5 * g.numel() * g.element_size()))
    return dg, du


def swiglu_bwd(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
               round_silu: bool = False) -> tuple:
    """(dg, du) of :func:`swiglu` at ``dy``: the plain version on the CPU,
    the kernel on CUDA."""
    if runs_plain(g, u, dy):
        return swiglu_bwd_plain(g, u, dy, round_silu)
    return swiglu_bwd_launch(g, u, dy.contiguous(), round_silu=round_silu)


swiglu_bwd.launches = 0


class SwiGLUFn(torch.autograd.Function):
    """Kernel forward and backward (or the plain versions, where
    :func:`runs_plain`).  Under recompute (``core/recompute.py``) the
    forward runs again before the backward; the backward itself reads the
    saved g and u and recomputes nothing."""

    @staticmethod
    def forward(ctx, g, u, round_silu=False):
        ctx.save_for_backward(g, u)
        ctx.round_silu = round_silu
        if runs_plain(g, u):
            return swiglu_plain(g, u, round_silu)
        return swiglu_launch(g, u, round_silu=round_silu)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        dg, du = swiglu_bwd(g, u, dy, ctx.round_silu)
        need_g, need_u = ctx.needs_input_grad[:2]
        return dg if need_g else None, du if need_u else None, None


def swiglu(g: torch.Tensor, u: torch.Tensor, *, round_silu: bool = False) -> torch.Tensor:
    """g, u: (..., f) of one shape and dtype.  Plain version on the CPU,
    the kernel on CUDA (through :class:`SwiGLUFn` when autograd records).
    ``round_silu``: the JAX trunk's arithmetic (module docstring)."""
    if runs_plain(g, u):
        return swiglu_plain(g, u, round_silu)
    if needs_grad(g, u):
        return SwiGLUFn.apply(g, u, round_silu)
    return swiglu_launch(g, u, round_silu=round_silu)


swiglu.launches = 0
