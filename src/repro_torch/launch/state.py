"""TrainState and its initialisation (the counterpart of
``repro.launch.state``; one device, so no sharding specs)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import MeCeFOConfig, ModelConfig, TrainConfig
from repro_torch.core.lowrank import init_projections
from repro_torch.models.params import init_params
from repro_torch.optim.optimizers import init_opt_state

Tree = Any


class TrainState(NamedTuple):
    step: int  # host int (the JAX package keeps an int32 device scalar)
    params: Tree
    opt: Any
    proj: Tree  # MeCeFO V1 tree ({} when MeCeFO is off)


def init_state(cfg: ModelConfig, train: TrainConfig, mecefo: MeCeFOConfig,
               generator: torch.Generator, dtype=None, device="cuda") -> TrainState:
    """Seeded params (``init_params``), zero moments and zero projections
    (valid before the first refresh), on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    params = init_params(cfg, generator, device, dtype)
    proj = init_projections(params, cfg, mecefo.rank) if mecefo.mode != "off" else {}
    return TrainState(step=0, params=params, opt=init_opt_state(params, train), proj=proj)
