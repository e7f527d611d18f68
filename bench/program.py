"""The system under test: the port's training step (``repro_torch``) built
for a cell, and the readings the check takes from it.

The step is ``repro_torch.launch.steps.make_train_step`` with the cell's
NDB mode (``"off"``, or ``"degraded"``: the neighbour that carries a
failed stage), MeCeFO's dynamic mode at the traffic file's rank, FFN
recompute, and the traffic file's step hyper-parameters; its state holds
the benchmark's weights (``bench/weights.py``), zero AdamW moments and, in
the neighbour, V1 from ``repro_torch.core.lowrank.refresh_projections``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

import weights as W
from spec import Cell

# the sizes a configuration file states, against the program's fields
_FIELDS = {"d": "d_model", "heads": "n_heads", "kv_heads": "n_kv_heads",
           "head_dim": "resolved_head_dim", "vocab": "padded_vocab", "layers": "n_layers",
           "qk_norm": "qk_norm", "norm_eps": "norm_eps", "rope_theta": "rope_theta",
           "dtype": "dtype"}


def program_config(cell: Cell):
    """The program's ``ModelConfig`` for the cell: its registered config
    with the stage's layers; raises where a size differs from the
    configuration file's."""
    from repro_torch.configs.base import get_config

    m = cell.sizes
    cfg = dataclasses.replace(get_config(cell.config["program_config"]), n_layers=m["layers"])
    got = {k: getattr(cfg, f) for k, f in _FIELDS.items()}
    want = {k: m[k] for k in _FIELDS}
    if m["moe"] is None:
        got["d_ff"], want["d_ff"] = cfg.d_ff, m["d_ff"]
    else:
        got["moe"] = {"experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                      "d_ff": cfg.moe.d_ff_expert, "capacity_factor": cfg.moe.capacity_factor,
                      "aux_loss_weight": cfg.moe.aux_loss_weight}
        want["moe"] = m["moe"]
    if got != want:
        raise ValueError(f"{cell.config_name}: the program runs {got}, the file states {want}")
    return cfg


def train_config(cell: Cell):
    from repro_torch.configs.base import TrainConfig

    t = cell.traffic["train"]
    return TrainConfig(learning_rate=t["learning_rate"], warmup_frac=t["warmup_frac"],
                       weight_decay=t["weight_decay"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                       grad_clip=t["grad_clip"])


class Program:
    """The cell's step and its state, built from the seed."""

    def __init__(self, cell: Cell, seed: int, device, spans: Dict[str, float], clock):
        from repro_torch.configs.base import MeCeFOConfig, ShapeConfig
        from repro_torch.core.lowrank import init_projections, refresh_projections
        from repro_torch.launch.state import TrainState
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.model import ExecFlags
        from repro_torch.models.params import param_shapes
        from repro_torch.optim.optimizers import init_opt_state

        t = cell.traffic
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg = cfg = program_config(cell)
        self.train = train_config(cell)
        mecefo = MeCeFOConfig(mode=t["mecefo"]["mode"], rank=int(t["mecefo"]["rank"]))
        specs = W.leaf_specs(cell.sizes)
        want = W.flatten(param_shapes(cfg))
        if {p: tuple(s) for p, s in specs} != {p: tuple(s) for p, s in want.items()}:
            raise ValueError("the benchmark's leaves differ from the program's tree")
        t0 = clock()
        params = W.nest(W.make_all(cell.sizes, seed, device, getattr(torch, cfg.dtype)))
        if device.type == "cuda":
            torch.cuda.synchronize()
        spans["weights_s"] = clock() - t0
        if t["ndb_mode"] == "degraded":
            t0 = clock()
            proj = refresh_projections(params, cfg, mecefo.rank)
            if device.type == "cuda":
                torch.cuda.synchronize()
            spans["v1_refresh_s"] = clock() - t0
        else:
            proj = init_projections(params, cfg, mecefo.rank)
        self.state = TrainState(step=0, params=params, opt=init_opt_state(params, self.train),
                                proj=proj)
        shape = ShapeConfig(cell.name, cell.seq_len, cell.batch, "train")
        self.step_fn = make_train_step(cfg, self.train, mecefo, shape, ndb_mode=t["ndb_mode"],
                                       total_steps=int(t["train"]["total_steps"]),
                                       flags=ExecFlags(remat=t["remat"]), device=device)

    def step(self, batch) -> Dict:
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's norm of the first clipped gradient, from AdamW's
        first moment after one step: m = (1 - b1) g."""
        ms = W.flatten(self.state.opt.m)
        return {p: float(x.norm()) / (1.0 - self.train.b1) for p, x in ms.items()}

    def change_norms(self) -> Dict[str, float]:
        return W.change_norms(W.flatten(self.state.params), self.cell.sizes, self.seed, self.dev)

    def free(self) -> None:
        self.state = self.step_fn = None


def launches() -> Dict[str, int]:
    """The port's kernel launch counters."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lowrank_wgrad import lowrank_wgrad_project

    return {"flash_attention": flash_attention.launches,
            "lowrank_wgrad": lowrank_wgrad_project.launches}


def build_kernels() -> None:
    """Build (or find built) the kernels a training step launches, all at
    once, into the program's build directory inside the checkout."""
    from repro_torch.kernels import _build

    _build.build_all(["rmsnorm", "swiglu", "flash_attention", "lowrank_wgrad"])

