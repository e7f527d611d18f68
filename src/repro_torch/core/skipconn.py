"""Technique I: drop the MHA module in the backward only (the counterpart
of ``repro.core.skipconn``).

On degraded (rank, layer) pairs the paper keeps the MHA forward but
propagates activation gradients through the residual branch only and
takes no MHA weight gradients from those ranks (eq. (1) then re-averages
over the unaffected ranks, ``core/grad_sync.py``).  ``grad_gate`` is the
identity in the forward; its backward multiplies the cotangent by a
per-example keep mask.  Where the whole batch is degraded (a constant
``keep == 0``), ``models/layers.py`` runs the MHA branch under
``torch.no_grad()`` instead, so nothing of it is saved for the backward.
"""
from __future__ import annotations

import torch


class GradGate(torch.autograd.Function):
    """Identity forward; backward ``dy * keep``, per example."""

    @staticmethod
    def forward(ctx, x, keep):
        if torch.is_tensor(keep):
            ctx.save_for_backward(keep)
            ctx.keep_const = None
        else:
            ctx.keep_const = float(keep)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        if ctx.keep_const is not None:
            return dy * ctx.keep_const, None
        k = ctx.saved_tensors[0].to(dy.dtype)
        if k.dim() == 1:  # per example (B,) -> broadcast over the trailing dims
            k = k.reshape(k.shape + (1,) * (dy.dim() - 1))
        return dy * k, None


def grad_gate(x: torch.Tensor, keep) -> torch.Tensor:
    """Identity in the forward; the backward scales the cotangent by
    ``keep`` (a scalar or a (B,) mask, batch on dim 0 of ``x``)."""
    return GradGate.apply(x, keep)


def cast_grad(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's identity whose backward casts the cotangent to the
    primal dtype.  PyTorch's autograd already casts every gradient it hands
    to a tensor to that tensor's dtype (the engine checks each backward's
    outputs against its inputs' metadata), so here it is the identity."""
    return x
