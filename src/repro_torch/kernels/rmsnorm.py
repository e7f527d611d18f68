"""RMSNorm: the wrapper around ``csrc/rmsnorm.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py:rmsnorm``.  Per row, in
f32: ``x * rsqrt(mean(x²) + eps) * scale``, cast back to ``x``'s dtype.  The
scale is applied in f32, as the TPU kernel and ``kernels/ref.py`` do; the
JAX trunk's ``layers.rmsnorm`` casts before the scale, which differs by
about one ulp in bf16 and agrees at f32.  Bound by bytes on the H100: see
the source note in ``csrc/rmsnorm.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn, on_cpu,
    stream_ptr,
)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,).  Plain version on the CPU, the kernel on
    CUDA."""
    if on_cpu(x, scale):
        return rmsnorm_plain(x, scale, eps)
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


rmsnorm.launches = 0
