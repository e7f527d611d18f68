"""RMSNorm: the wrapper around ``csrc/rmsnorm.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``.  Per row, in
f32: ``x * rsqrt(mean(x²) + eps) * scale``, cast back to ``x``'s dtype.  The
scale is applied in f32, as the TPU kernel and ``kernels/ref.py`` do; the
JAX trunk's ``layers.rmsnorm`` casts before the scale, which differs by
about one ulp in bf16 and agrees at f32.  Bound by bytes on the H100: see
the source note in ``csrc/rmsnorm.cu``.

Under grad the kernel runs inside :class:`RMSNormFn`, whose backward
recomputes the plain version and differentiates it (the JAX package has no
Pallas backward for this kernel either: JAX differentiates the jnp trunk).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn, needs_grad,
    recompute_grads, refuse_detach, runs_plain, stream_ptr,
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
    rows = x.numel() // d if d else 0
    vec = int(d % (16 // x.element_size()) == 0 and aligned16(x, scale, y))
    fn = kernel_fn("rmsnorm", "rmsnorm_launch", [PTR, PTR, PTR, INT, INT, FLOAT, INT, INT, PTR])
    err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
             code, vec, stream_ptr(x))
    check_launch("rmsnorm", err)
    rmsnorm.launches += 1
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
