"""The training cell, and where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --modes off degraded

The cell is the one ``chip_smoke.py``'s train phase runs (it imports it from
here): full-width, full-depth llama-350m (bf16, weights from seed 0) at
B=8, S=1024, rank 64, FFN recompute, under ``NDBPlan(n_dp=4, n_stages=8,
failed={(1, 3)})``.  The profile refreshes V1 and, for each NDB mode, runs
two warm-up steps and then one step under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON line per mode: the step's wall time, the
device time summed over its kernels, the device busy and idle shares, the
kernels that take the most device time, and each of the port's kernels'
share of the device time.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.configs.base import (
    MeCeFOConfig, ModelConfig, ShapeConfig, TrainConfig, get_config,
)
from repro_torch.core.lowrank import refresh_projections
from repro_torch.core.ndb import NDBPlan, plan_to_masks
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.state import TrainState
from repro_torch.launch.steps import NDB_MODES, make_train_step
from repro_torch.models.model import ExecFlags
from repro_torch.models.params import init_params, tree_map
from repro_torch.optim.optimizers import init_opt_state

CONFIG, BATCH, SEQ_LEN, RANK = "llama-350m", 8, 1024, 64
PLAN = NDBPlan(n_dp=4, n_stages=8, failed=frozenset({(1, 3)}))
FLAGS = ExecFlags(remat="ffn")  # the Trainer's default (repro/launch/train.py:83-85)
# the port's kernels by the names of their CUDA functions (csrc/*.cu)
PORT_KERNELS = {"lowrank_wgrad": "lowrank_", "flash_attention": "flash_fwd_",
                "rmsnorm": "rmsnorm_kernel", "swiglu": "swiglu_kernel"}


@dataclass
class TrainCell:
    cfg: ModelConfig
    train: TrainConfig
    mecefo: MeCeFOConfig
    shape: ShapeConfig
    params: Any       # weights from the seed, never updated
    proj: Any         # V1, refreshed from ``params`` before the first step
    keep: np.ndarray  # (L, B) keep mask of PLAN
    weight: np.ndarray  # (B,) example weights of PLAN
    svd_s: float      # wall time of the V1 refresh

    def source(self) -> SyntheticLM:
        return SyntheticLM(self.cfg.vocab_size)

    def state(self) -> TrainState:
        """A fresh state: a copy of the seeded weights, zero moments."""
        params = tree_map(lambda t: t.clone(), self.params)
        return TrainState(step=0, params=params, opt=init_opt_state(params, self.train),
                          proj=self.proj)

    def step(self, mode: str, device):
        """(step, extra args of each call) for one NDB mode."""
        step = make_train_step(
            self.cfg, self.train, self.mecefo, self.shape, ndb_mode=mode,
            static_ndb=(self.keep, self.weight) if mode == "static" else None,
            total_steps=self.train.steps, flags=FLAGS, device=device)
        ndb = ({"keep": self.keep, "example_weight": self.weight},) if mode == "dynamic" else ()
        return step, ndb


def train_cell(device, seed: int = 0) -> TrainCell:
    cfg = get_config(CONFIG)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    t0 = time.perf_counter()
    proj = refresh_projections(params, cfg, RANK)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    svd_s = time.perf_counter() - t0
    keep, weight = plan_to_masks(PLAN, cfg, BATCH)
    return TrainCell(cfg, TrainConfig(), MeCeFOConfig(mode="dynamic", rank=RANK),
                     ShapeConfig("smoke", SEQ_LEN, BATCH, "train"), params, proj, keep,
                     weight, svd_s)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", default=["off", "degraded"], choices=NDB_MODES)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cell = train_cell(dev)
    batch = cell.source().batch(0, BATCH, SEQ_LEN)
    out = []
    for mode in args.modes:
        state = cell.state()
        step, ndb = cell.step(mode, dev)
        for _ in range(2):  # warm-up
            state, _m = step(state, batch, *ndb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch, *ndb)
            float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()

        def dev_us(e) -> float:
            return float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))

        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_s = sum(dev_us(e) for e in kernels) / 1e6
        top = sorted(kernels, key=dev_us, reverse=True)[:15]
        row = {
            "config": cell.cfg.name, "n_layers": cell.cfg.n_layers, "mode": mode,
            "device": torch.cuda.get_device_name(0), "batch": BATCH,
            "seq_len": SEQ_LEN, "rank": RANK, "wall_s": wall,
            "device_kernel_s": kernel_s, "device_busy_share": kernel_s / wall,
            "device_idle_share": 1.0 - kernel_s / wall,
            "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_s": dev_us(e) / 1e6}
                            for e in top],
            "port_kernel_share": {
                name: sum(dev_us(e) for e in kernels if tag in e.key) / 1e6 / kernel_s
                for name, tag in PORT_KERNELS.items()},
        }
        print(json.dumps(row), flush=True)
        out.append(row)
        del state, step
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
