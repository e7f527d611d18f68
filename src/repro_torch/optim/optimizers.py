"""AdamW and momentum SGD (the counterpart of ``repro.optim.optimizers``).

Moments are f32; bf16 params are updated in f32 arithmetic and cast back.
:func:`apply_update` updates params and moments **in place**, where the JAX
package builds new trees, so a step holds no second copy of the optimizer
state.  Learning rates and bias corrections are computed on the host in
float32, as the JAX package computes them on the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map

Tree = Any

F32 = np.float32


class AdamWState(NamedTuple):
    m: Tree
    v: Tree


class SGDMState(NamedTuple):
    m: Tree


def init_opt_state(params: Tree, cfg: TrainConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.optimizer == "adamw":
        return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params))
    if cfg.optimizer == "sgdm":
        return SGDMState(m=tree_map(zeros, params))
    raise ValueError(cfg.optimizer)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """f32 gradients scaled to a global norm of at most ``max_norm``, and
    the norm before clipping."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def apply_update(params: Tree, grads: Tree, opt_state, lr: float, step: int, cfg: TrainConfig):
    """One optimizer step, in place; returns ``(params, opt_state)`` (the
    same tensors).  ``grads`` must already be f32 (post-clip)."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    lr = F32(lr)
    if cfg.optimizer == "adamw":
        b1, b2 = F32(cfg.b1), F32(cfg.b2)
        ms, vs = tree_leaves(opt_state.m), tree_leaves(opt_state.v)
        torch._foreach_mul_(ms, float(b1))
        torch._foreach_add_(ms, gs, alpha=float(F32(1 - cfg.b1)))
        torch._foreach_mul_(vs, float(b2))
        torch._foreach_addcmul_(vs, gs, gs, value=float(F32(1 - cfg.b2)))
        t = F32(step) + F32(1)
        bc1, bc2 = F32(1) - b1 ** t, F32(1) - b2 ** t
        for p, m, v in zip(ps, ms, vs):
            pf = p.float()
            upd = (m / float(bc1)) / ((v / float(bc2)).sqrt() + cfg.eps) + cfg.weight_decay * pf
            p.copy_(pf - float(lr) * upd)
        return params, opt_state
    if cfg.optimizer == "sgdm":
        # the paper's update: m_t = b m_{t-1} + (1-b) g_t ; w_{t+1} = w_t - eta m_t
        b = F32(cfg.momentum)
        ms = tree_leaves(opt_state.m)
        torch._foreach_mul_(ms, float(b))
        torch._foreach_add_(ms, gs, alpha=float(F32(1 - cfg.momentum)))
        for p, m in zip(ps, ms):
            p.copy_(p.float() - float(lr) * m)
        return params, opt_state
    raise ValueError(cfg.optimizer)


def lr_schedule(cfg: TrainConfig, total_steps: int):
    """Linear warmup over ``warmup_frac`` of the steps, then cosine decay
    to 10 % of the peak; ``lr(step)`` is a float32 number."""
    warmup = max(int(total_steps * cfg.warmup_frac), 1)
    peak = F32(cfg.learning_rate)

    def lr(step) -> float:
        s = F32(step)
        if s < warmup:
            return float(peak * s / F32(warmup))
        prog = np.clip((s - F32(warmup)) / F32(max(total_steps - warmup, 1)), F32(0), F32(1))
        return float(peak * (F32(0.1) + F32(0.45) * (F32(1) + np.cos(F32(np.pi) * prog))))

    return lr
