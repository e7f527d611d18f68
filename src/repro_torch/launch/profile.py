"""The training cells, and where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --modes off degraded
    PYTHONPATH=src python -m repro_torch.launch.profile --config mamba2-2.7b

The llama cell is the one ``chip_smoke.py``'s train phase runs (it imports
it from here): full-width, full-depth llama-350m (bf16, weights from seed
0) at B=8, S=1024, rank 64, FFN recompute, under ``NDBPlan(n_dp=4,
n_stages=8, failed={(1, 3)})``.  The mamba2 cell is full-width, full-depth
mamba2-2.7b at B=1 (the largest batch whose healthy step fits the card),
S=1024, under ``NDBPlan(n_dp=1, n_stages=8, failed={(0, 3)})``.  The
profile refreshes V1 and, for each NDB mode, runs two warm-up steps and
then one step under ``torch.profiler`` (CPU and CUDA activities).  Prints
one JSON line per mode: the step's wall time, the device time summed over
its kernels, the device busy and idle shares (busy: the union of the
device operations' intervals in the step's window, as ``bench/devtrace.py``
takes it, since kernels on two streams overlap), the device ms of each
phase of the step from its spans (``obs/spans.py``'s ``Tracer.step_ms``,
the spans the benchmark's ``step.*`` and ``mecefo.*`` metrics read), the
kernels that take the most device time, and each of the port's kernels'
share of the device time; for an SSM config also the SSD scan's share
(``ssd_scan_ms``: the scan's forward and backward timed alone at the
step's shapes, times the SSM layers, the forward twice where technique II
recomputes it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Optional

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
from repro_torch.obs.catalog import TRACED_SPAN_SET
from repro_torch.obs.spans import get_tracer
from repro_torch.optim.optimizers import init_opt_state

CONFIG, BATCH, SEQ_LEN, RANK = "llama-350m", 8, 1024, 64
PLAN = NDBPlan(n_dp=4, n_stages=8, failed=frozenset({(1, 3)}))
# the SSM cell: one sequence a step (B 2 runs out of the card's memory in
# the healthy step), so the plan has one DP rank
SSM_CONFIG, SSM_BATCH = "mamba2-2.7b", 1
SSM_PLAN = NDBPlan(n_dp=1, n_stages=8, failed=frozenset({(0, 3)}))
CELLS = {CONFIG: (BATCH, PLAN), SSM_CONFIG: (SSM_BATCH, SSM_PLAN)}
FLAGS = ExecFlags(remat="ffn")  # the Trainer's default (repro/launch/train.py:83-85)
# the port's kernels by the names of their CUDA functions (csrc/*.cu)
PORT_KERNELS = {"lowrank_wgrad": "lowrank_", "flash_attention": "flash_fwd_",
                "rmsnorm": "rmsnorm_", "swiglu": "swiglu_kernel",
                "swiglu_bwd": "swiglu_bwd_kernel"}
# a step's phases by the span each is read from: (span, enclosing span)
PHASES = {"h2d": ("train.h2d", None), "forward": ("train.forward", None),
          "backward": ("train.backward", None), "clip": ("train.clip", None),
          "optimizer": ("train.optimizer", None),
          "recompute": ("mecefo.ffn", "train.backward"),
          "lowrank_wgrad": ("mecefo.lowrank_wgrad", None),
          "attention_backward": ("attn.backward", None)}


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


def train_cell(device, seed: int = 0, config: str = CONFIG, params=None, proj=None,
               svd_s: float = 0.0, n_layers: Optional[int] = None) -> TrainCell:
    """The cell of ``config`` (a key of CELLS), cut to ``n_layers`` where
    given; ``params`` and ``proj`` given are used as they are (no
    refresh)."""
    cfg = get_config(config)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    batch, plan = CELLS[config]
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    if proj is None:
        t0 = time.perf_counter()
        proj = refresh_projections(params, cfg, RANK)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        svd_s = time.perf_counter() - t0
    keep, weight = plan_to_masks(plan, cfg, batch)
    return TrainCell(cfg, TrainConfig(), MeCeFOConfig(mode="dynamic", rank=RANK),
                     ShapeConfig("smoke", SEQ_LEN, batch, "train"), params, proj, keep,
                     weight, svd_s)


def _kernels(prof) -> list:
    """A profile's CUDA entries, without the spans' mirrors on the device's
    timeline (``obs/spans.py``), which are annotations, not device work."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in TRACED_SPAN_SET]


def _device_s(prof) -> float:
    """Device seconds summed over a profile's CUDA kernels."""
    return sum(float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))
               for e in _kernels(prof)) / 1e6


def busy_s(events, t0_ns: int, t1_ns: int) -> float:
    """The seconds of ``[t0_ns, t1_ns]`` in which some device operation
    ran: the union of the CUDA events' intervals among a profile's raw
    events (``profiler.kineto_results.events()``), leaving out the host
    annotations the profiler mirrors on the device's timeline."""
    spans = []
    for e in events:
        if "CUDA" not in str(e.device_type()) or e.is_user_annotation():
            continue
        a, b = max(e.start_ns(), t0_ns), min(e.start_ns() + e.duration_ns(), t1_ns)
        if b > a:
            spans.append((a, b))
    total, end = 0, t0_ns
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e9


def phase_ms(t0_ns: int, t1_ns: int) -> dict:
    """Each phase's device ms (``PHASES``), the median over the steps whose
    ``train.step`` span lies in ``[t0_ns, t1_ns]`` (the profiler's clock);
    a phase whose span never opened is left out, and so is every phase off
    CUDA."""
    tracer = get_tracer()
    out = {}
    for key, (name, under) in PHASES.items():
        got = sorted(tracer.step_ms(name, t0_ns, t1_ns, under=under))
        if got:
            out[key] = got[len(got) // 2]
    return out


def ssd_scan_ms(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """The SSD scan (``models/ssm.py:ssd_chunked``) of one layer alone at
    the step's shapes: forward and forward+backward device ms (its kernels'
    device time under ``torch.profiler``, a mean over 5 calls after a
    warm-up), on seeded inputs in the model dtype."""
    from repro_torch.models.ssm import ssd_chunked

    ssm = cfg.ssm
    nh = ssm.expand * cfg.d_model // ssm.head_dim
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dt).requires_grad_()

    xh, b, c = (randn(batch, seq_len, nh, ssm.head_dim), randn(batch, seq_len, ssm.d_state),
                randn(batch, seq_len, ssm.d_state))
    dtv = torch.nn.functional.softplus(randn(batch, seq_len, nh).float()).detach().requires_grad_()
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dt)

    def fwd():
        return ssd_chunked(xh, dtv, a_log, b, c, ssm.chunk)[0]

    def fwd_bwd():
        torch.autograd.grad(fwd(), [xh, dtv, b, c], torch.ones_like(xh))

    out = {}
    for name, fn in (("forward_ms", fwd), ("forward_backward_ms", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        out[name] = 1e3 * _device_s(prof) / 5
    return out


def profile_step(cell: TrainCell, mode: str, device, warmup: int = 2) -> dict:
    """One step of ``cell`` in ``mode`` under ``torch.profiler`` after
    ``warmup`` steps, from a fresh state; the row ``main`` prints."""
    batch = cell.source().batch(0, cell.shape.global_batch, SEQ_LEN)
    state = cell.state()
    step, ndb = cell.step(mode, device)
    for _ in range(warmup):
        state, _m = step(state, batch, *ndb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0, w0 = time.perf_counter(), time.time_ns()
        state, metrics = step(state, batch, *ndb)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall, w1 = time.perf_counter() - t0, time.time_ns()
    busy = busy_s(prof.profiler.kineto_results.events(), w0, w1)

    def dev_us(e) -> float:
        return float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))

    kernels = _kernels(prof)
    kernel_s = _device_s(prof)
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    cfg = cell.cfg
    row = {
        "config": cfg.name, "n_layers": cfg.n_layers, "mode": mode,
        "device": torch.cuda.get_device_name(0), "batch": cell.shape.global_batch,
        "seq_len": SEQ_LEN, "rank": RANK, "wall_s": wall,
        "device_kernel_s": kernel_s, "device_busy_share": busy / wall,
        "device_idle_share": 1.0 - busy / wall, "phase_ms": phase_ms(w0, w1),
        "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_s": dev_us(e) / 1e6}
                        for e in top],
        "port_kernel_share": {
            name: sum(dev_us(e) for e in kernels if tag in e.key) / 1e6 / kernel_s
            for name, tag in PORT_KERNELS.items()},
    }
    del state, step
    if cfg.ssm is not None:
        scan = ssd_scan_ms(cfg, cell.shape.global_batch, SEQ_LEN, device)
        n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
        # technique II recomputes the whole SSM block (its scan's forward)
        # in degraded mode
        extra_fwd = scan["forward_ms"] if mode == "degraded" and cell.mecefo.recompute_ffn else 0.0
        scan_s = n_ssm * (scan["forward_backward_ms"] + extra_fwd) / 1e3
        row.update({"ssd_scan_layer_ms": scan, "ssd_scan_step_s": scan_s,
                    "ssd_scan_share_of_device_time": scan_s / kernel_s})
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", default=["off", "degraded"], choices=NDB_MODES)
    ap.add_argument("--config", default=CONFIG, choices=sorted(CELLS))
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cell = train_cell(dev, config=args.config)
    out = []
    for mode in args.modes:
        row = profile_step(cell, mode, dev)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
