"""RMSNorm: the wrapper around ``csrc/rmsnorm.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``.  Per row, in
f32: ``x * rsqrt(mean(x²) + eps) * scale``, cast back to ``x``'s dtype.  The
scale is applied in f32, as the TPU kernel and ``kernels/ref.py`` do; the
JAX trunk's ``layers.rmsnorm`` casts before the scale, which differs by
about one ulp in bf16 and agrees at f32.  Bound by bytes on the H100; the
kernel holds whole rows in registers for the widths the configs use (16
lanes a row at d = 128 in bf16) and reduces each row in an order fixed by
``d`` and the dtype, so a row's output does not depend on the rows around
it: see the source note in ``csrc/rmsnorm.cu``.

Under grad the kernel runs inside :class:`RMSNormFn`, whose backward
recomputes the plain version and differentiates it (the JAX package has no
Pallas backward for this kernel either: JAX differentiates the jnp trunk).

The split form norms a row that a ``model`` axis cut (the SSM mixer's
``gate_norm`` over d_inner, each rank holding d_inner/M channels):
:func:`rmsnorm_sumsq` gives each row's f32 sum of squares over the local
channels, the caller sums them over the model group, and
:func:`rmsnorm_apply` norms the local channels by the summed value and the
whole width.  Two launches of ``csrc/rmsnorm.cu``'s warp-a-row walk, each
with its plain version and an autograd Function whose backward
differentiates the plain composition.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, book, check_launch, check_operand, dtype_code, kernel_fn,
    needs_grad, on_meta, recompute_grads, refuse_detach, runs_plain, stream_ptr,
)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_launch(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad)."""
    refuse_detach("rmsnorm", x, scale)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)}, want ({d},)")
    check_operand(x, "x")
    check_operand(scale, "scale", x.dtype)
    code = dtype_code(x)
    y = torch.empty_like(x)
    if y.numel() == 0:  # nothing to launch (an empty grid is invalid)
        return y
    rows = x.numel() // d
    if not on_meta(x):
        vec = int(d % (16 // x.element_size()) == 0 and aligned16(x, scale, y))
        fn = kernel_fn("rmsnorm", "rmsnorm_launch",
                       [PTR, PTR, PTR, INT, INT, FLOAT, INT, INT, PTR])
        err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
                 code, vec, stream_ptr(x))
        check_launch("rmsnorm", err)
        rmsnorm.launches += 1
    es = x.element_size()
    book("rmsnorm", lambda: (4.0 * x.numel(), 2 * x.numel() * es + d * es))
    return y


class RMSNormFn(torch.autograd.Function):
    """Kernel forward (or the plain version, where :func:`runs_plain`);
    backward through the recomputed plain version."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if runs_plain(x, scale):
            return rmsnorm_plain(x, scale, eps)
        return rmsnorm_launch(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*recompute_grads(rmsnorm_plain, ctx.saved_tensors, ctx.needs_input_grad[:2],
                                 dy, ctx.eps), None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Plain version on the CPU, the kernel on
    CUDA (through :class:`RMSNormFn` when autograd records)."""
    if runs_plain(x, scale):
        return rmsnorm_plain(x, scale, eps)
    if needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return rmsnorm_launch(x, scale, eps)


rmsnorm.launches = 0


def rmsnorm_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().sum(dim=-1)


def rmsnorm_apply_plain(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor, d_whole: int,
                        eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(ss[..., None] / d_whole + eps) * scale.float()).to(x.dtype)


def _rows_vec(x: torch.Tensor, *others: torch.Tensor):
    d = x.shape[-1]
    return x.numel() // d, d, int(d % (16 // x.element_size()) == 0 and aligned16(x, *others))


def rmsnorm_sumsq_launch(x: torch.Tensor) -> torch.Tensor:
    """The bare CUDA launch of the split form's first pass."""
    refuse_detach("rmsnorm_sumsq", x)
    check_operand(x, "x")
    code = dtype_code(x)
    ss = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if ss.numel() == 0:
        return ss
    if not on_meta(x):
        rows, d, vec = _rows_vec(x)
        fn = kernel_fn("rmsnorm", "rmsnorm_sumsq_launch", [PTR, PTR, INT, INT, INT, INT, PTR])
        check_launch("rmsnorm", fn(x.data_ptr(), ss.data_ptr(), rows, d, code, vec,
                                   stream_ptr(x)), "rmsnorm_sumsq")
        rmsnorm_sumsq.launches += 1
    book("rmsnorm_sumsq",
         lambda: (2.0 * x.numel(), x.numel() * x.element_size() + ss.numel() * 4))
    return ss


def rmsnorm_apply_launch(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor, d_whole: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """The bare CUDA launch of the split form's second pass."""
    refuse_detach("rmsnorm_apply", x, ss, scale)
    d = x.shape[-1]
    if scale.shape != (d,) or ss.shape != x.shape[:-1]:
        raise ValueError(f"scale {tuple(scale.shape)} and ss {tuple(ss.shape)} for x "
                         f"{tuple(x.shape)}")
    check_operand(x, "x")
    check_operand(ss, "ss", torch.float32)
    check_operand(scale, "scale", x.dtype)
    code = dtype_code(x)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    if not on_meta(x):
        rows, d, vec = _rows_vec(x, scale)
        fn = kernel_fn("rmsnorm", "rmsnorm_apply_launch",
                       [PTR, PTR, PTR, PTR, INT, INT, INT, FLOAT, INT, INT, PTR])
        err = fn(x.data_ptr(), ss.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                 int(d_whole), float(eps), code, vec, stream_ptr(x))
        check_launch("rmsnorm", err, "rmsnorm_apply")
        rmsnorm_apply.launches += 1
    es = x.element_size()
    book("rmsnorm_apply",
         lambda: (2.0 * x.numel() + ss.numel(), 2 * x.numel() * es + ss.numel() * 4 + d * es))
    return y


class RMSNormSumSqFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return rmsnorm_sumsq_plain(x) if runs_plain(x) else rmsnorm_sumsq_launch(x)

    @staticmethod
    def backward(ctx, dss):
        return recompute_grads(rmsnorm_sumsq_plain, ctx.saved_tensors, ctx.needs_input_grad, dss)


class RMSNormApplyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ss, scale, d_whole, eps):
        ctx.save_for_backward(x, ss, scale)
        ctx.consts = (d_whole, eps)
        if runs_plain(x, ss, scale):
            return rmsnorm_apply_plain(x, ss, scale, d_whole, eps)
        return rmsnorm_apply_launch(x, ss, scale, d_whole, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*recompute_grads(rmsnorm_apply_plain, ctx.saved_tensors,
                                 ctx.needs_input_grad[:3], dy, *ctx.consts), None, None)


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (...) f32: each row's sum of squares (the split form's
    first pass; kernel on CUDA, plain version on the CPU)."""
    if runs_plain(x):
        return rmsnorm_sumsq_plain(x)
    if needs_grad(x):
        return RMSNormSumSqFn.apply(x)
    return rmsnorm_sumsq_launch(x)


def rmsnorm_apply(x: torch.Tensor, ss: torch.Tensor, scale: torch.Tensor, d_whole: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) local channels of rows ``d_whole`` wide; ss: (...) f32,
    each whole row's sum of squares; scale: (d,) the local channels'.  The
    split form's second pass."""
    if runs_plain(x, ss, scale):
        return rmsnorm_apply_plain(x, ss, scale, d_whole, eps)
    if needs_grad(x, ss, scale):
        return RMSNormApplyFn.apply(x, ss, scale, d_whole, eps)
    return rmsnorm_apply_launch(x, ss, scale, d_whole, eps)


rmsnorm_sumsq.launches = 0
rmsnorm_apply.launches = 0
