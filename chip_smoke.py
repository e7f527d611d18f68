#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU and ``nvcc``; exits non-zero without them.  Phases,
each printing JSON lines:

1. build   — compile every kernel from ``src/repro_torch/csrc`` (one nvcc
             per source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card at
             the serving and training paths' shapes, in bf16 and f32, with
             its time, the plain version's time, its bound and (where one
             PyTorch call computes the same function) that call's time; the
             paged decode also bitwise-invariant to the physical page
             layout, with exact zeros on length-0 lanes; the low-rank Wgrad
             bitwise repeatable, and its limit shown to catch a kernel that
             rounds x @ V1 to bf16; the norm, activation and attention
             kernels also at the training path's shapes, where each
             autograd Function's gradient must equal the plain version's
             (a check of the wiring: the backward recomputes the plain
             version).
3. serve   — full-width qwen3-0.6b (bf16, seeded weights) serves 16 seeded
             requests to completion through the port's engine; every
             kernel's launch count must grow during that run.
4. parity  — two of those requests, prefill and 16 decode steps, through
             the kernels and through the plain versions (teacher-forced with
             the kernel path's tokens), in bf16 at full depth and in f32 on a
             4-layer full-width copy.
5. train   — full-width, full-depth llama-350m (bf16, seeded weights, B=8,
             S=1024, rank 64, FFN recompute) takes 3 MeCeFO training steps in
             each NDB mode (off, dynamic, static, degraded) under the plan
             NDBPlan(n_dp=4, n_stages=8, failed={(1, 3)}); one line per mode
             with losses, step time, tokens/s, peak memory and launches per
             step.  Launch counts must match the ones derived from the model,
             the losses be finite, and the degraded step's peak memory lie
             below the healthy one's.
6. train parity — one step's loss and gradients through the kernels and
             through the plain versions, with the train phase's FFN
             recompute: in bf16 at full depth (dynamic, degraded) and in f32
             on a 4-layer full-width copy (all four modes).

Then the kernels' summary line, the card's name and power limit, and the
final ``{"ok": true, ...}`` line.  Any failed check raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import MeCeFOConfig, get_config  # noqa: E402
from repro_torch.core.lowrank import refresh_projections  # noqa: E402
from repro_torch.core.ndb import NDBContext, plan_to_masks  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, plain_versions  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.lowrank_wgrad import (  # noqa: E402
    lowrank_wgrad_project, lowrank_wgrad_project_plain,
)
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.swiglu import swiglu, swiglu_plain  # noqa: E402
from repro_torch.launch.profile import (  # noqa: E402
    BATCH as TRAIN_B, CONFIG as TRAIN_CONFIG, FLAGS as TRAIN_FLAGS, PLAN as TRAIN_PLAN,
    RANK as TRAIN_RANK, SEQ_LEN as TRAIN_S, train_cell,
)
from repro_torch.launch.steps import loss_and_grads, to_device  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import ExecFlags, forward_decode, forward_prefill  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.kvpool import init_pool, pages_needed, scatter_prefill  # noqa: E402
from repro_torch.serve.request import WorkloadSpec, build_workload  # noqa: E402
from repro_torch.serve.sampling import greedy_token  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor cores; f32 FMA

# kernel vs plain version: f32 sums in other orders (a few ulps); bf16
# outputs round on either side of a bf16 boundary (one ulp = 2^-7 relative)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2 ** -7)}

WRAPPERS = {
    "rmsnorm": rmsnorm, "swiglu": swiglu,
    "flash_attention": flash_attention, "paged_decode": paged_decode,
    "lowrank_wgrad": lowrank_wgrad_project,
}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
    "swiglu": "src/repro/kernels/swiglu.py:20",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "paged_decode": "src/repro/kernels/paged_decode.py:51",
    "lowrank_wgrad": "src/repro/kernels/lowrank_wgrad.py:44",
}
SERVE_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "paged_decode")
TRAIN_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "lowrank_wgrad")

# kernel #6 against its plain version, relative to max |ref|.  Both sides
# multiply the same operands (bf16 or f32) with f32 products and sums, so
# they differ only in summation order: at most 1e-6 of max |ref| on the
# H100 in either dtype.  A kernel that rounds P = x @ V1 to bf16 lands
# near 1e-3 (the control in lowrank_rows shows this limit catches it).
LOWRANK_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}

# the training slice's cell (launch/profile.py: llama-350m, B=8, S=1024,
# rank 64, FFN recompute); the low-rank Wgrad's (T, n, m, r) for
# w_gate/w_up and w_down, and an odd one
TRAIN_MODES = ("off", "dynamic", "static", "degraded")
TRAIN_STEPS = 3
LOWRANK_SHAPES = [(8192, 1024, 2736, 64), (8192, 2736, 1024, 64), (300, 100, 260, 12)]
# train parity: one step's loss and gradients, kernels vs plain versions,
# as (max per-leaf ||Δg||/||g||, loss |Δ|/|loss|).  f32: the same arithmetic
# summed in other orders.  bf16: each layer rounds its norm, activation and
# attention outputs to bf16 where the two paths may land one ulp (2^-8
# relative) apart, and 24 layers of such differences reach every gradient
# leaf: at most 2.6 % (dynamic) and 2.5 % (degraded) on the H100, so the
# limit is 5 %; a wrong kernel moves a leaf by its whole norm.  The bf16
# check is also anchored to the f32 step (TRAIN_ANCHOR_RATIO).
TRAIN_PARITY_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 1e-3)}
TRAIN_ANCHOR_RATIO = 1.5

# the serving slice's shapes (qwen3-0.6b)
B_PRE, S_PRE, H, KV, HD, D, DFF = 4, 512, 16, 8, 128, 1024, 3072
B_DEC, PS, P_DEC = 8, 16, 64
DEC_LENS = [0, 1, 15, 16, 17, 300, 777, 1024]
ECFG = EngineConfig(max_slots=8, page_size=16, pages_per_slot=64)
SPEC = WorkloadSpec(n_requests=16, vocab_size=151936, prompt_len=(64, 512),
                    new_tokens=(16, 64), seed=0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


class ColdTimer:
    """Median device time of one call, with the 50 MB L2 cache flushed
    before every call (CUDA events around the call alone)."""

    def __init__(self, dev):
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, dtype, shape, out, ref, timer, call_k, call_p, moved, ops, call_lib=None):
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all()) and bool(torch.isfinite(out.float()).all())
    b_ms, b_by = bound(moved, ops, dtype)
    row = {
        "phase": "kernels", "kernel": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": shape, "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol,
        "ok": ok, "ms": timer(call_k), "plain_ms": timer(call_p),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(call_lib) if call_lib is not None else None,
    }
    emit(row)
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: max abs err {row['max_abs_err']}")
    return row


def compare_rel(name, dtype, shape, out, ref, timer, call_k, call_p, moved, ops, call_lib):
    """A row held relative to max |ref| (kernel #6's tolerance)."""
    tol = LOWRANK_TOL[dtype]
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max()) + 1e-6
    ok = err <= tol * scale and bool(torch.isfinite(out).all())
    b_ms, b_by = bound(moved, ops, dtype)
    row = {
        "phase": "kernels", "kernel": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": shape, "max_abs_err": err, "max_abs_ref": scale, "rel_tol": tol, "ok": ok,
        "ms": timer(call_k), "plain_ms": timer(call_p), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer(call_lib),
    }
    emit(row)
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: max abs err {err} > {tol} * {scale}")
    return row


def lowrank_rows(dev, timer, randn) -> dict:
    """Kernel #6 at the training path's shapes and an odd one, bitwise
    repeatable; the yardstick is one torch.linalg.multi_dot call.  A control
    rounds P = x @ V1 to bf16 (the precision a tensor-core rewrite could be
    tempted to take) and must fail the same limit."""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for T, n, m, r in LOWRANK_SHAPES:
            x, dy, v1 = randn(T, n, dtype=dtype), randn(T, m, dtype=dtype), randn(n, r, dtype=dtype)
            a = lowrank_wgrad_project(x, dy, v1)
            repeat = bool(torch.equal(a, lowrank_wgrad_project(x, dy, v1)))
            ref = lowrank_wgrad_project_plain(x, dy, v1)
            row = compare_rel(
                "lowrank_wgrad", dtype, [T, n, m, r], a, ref,
                timer, lambda: lowrank_wgrad_project(x, dy, v1),
                lambda: lowrank_wgrad_project_plain(x, dy, v1),
                nbytes(x, dy, v1) + r * m * 4, 2.0 * T * r * (n + m),
                lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
            p_bf16 = (x.float() @ v1.float()).to(torch.bfloat16).float()
            control = float((p_bf16.T @ dy.float() - ref).abs().max())
            caught = control > LOWRANK_TOL[dtype] * row["max_abs_ref"]
            emit({"phase": "kernels", "kernel": "lowrank_wgrad", "dtype": row["dtype"],
                  "shape": [T, n, m, r], "bitwise_repeat": repeat,
                  "control_p_in_bf16_max_abs_err": control, "control_caught": caught})
            if not repeat:
                raise AssertionError(f"lowrank_wgrad {dtype} {[T, n, m, r]}: not bitwise repeatable")
            if not caught:
                raise AssertionError(f"lowrank_wgrad {dtype} {[T, n, m, r]}: the limit passes "
                                     f"a P rounded to bf16 ({control})")
            rows.setdefault(("lowrank_wgrad", dtype), row)
    return rows


def train_shape_rows(timer, randn) -> None:
    """The norm, activation and attention kernels at the training path's
    shapes (the flash kernel's head_dim 64 MHA instantiation among them),
    each held against its plain version as the serving rows are, in bf16
    and f32.  Then the wiring of each autograd Function: its output must
    carry autograd history, and its gradient equal the plain version's
    autograd gradient exactly (its backward recomputes the plain version,
    so this checks the Function, not the kernel)."""
    import torch.nn.functional as F

    B, S, H, hd, D, FF = TRAIN_B, TRAIN_S, 16, 64, 1024, 2736
    T = B * S
    pairs = B * H * S * (S + 1) // 2  # (query, key) pairs the mask keeps
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        x, sc = randn(T, D, dtype=dtype), randn(D, dtype=dtype)
        g, u = randn(T, FF, dtype=dtype), randn(T, FF, dtype=dtype)
        q, k, v = (randn(B, S, H, hd, dtype=dtype) for _ in range(3))
        cases = {
            "rmsnorm": (rmsnorm, rmsnorm_plain, (x, sc), [T, D],
                        2 * x.numel() * es + D * es, 4.0 * x.numel(),
                        lambda: F.rms_norm(x, (D,), sc, 1e-5)),
            "swiglu": (swiglu, swiglu_plain, (g, u), [T, FF], 3 * g.numel() * es,
                       5.0 * g.numel(), None),
            "flash_attention": (flash_attention, flash_attention_plain, (q, k, v),
                                [B, S, H, H, hd], 4 * nbytes(q), 4.0 * hd * pairs,
                                sdpa_call(q, k, v)),
        }
        for name, (kernel, plain, inputs, shape, moved, ops, lib) in cases.items():
            a = [t.clone().requires_grad_() for t in inputs]
            b = [t.clone().requires_grad_() for t in inputs]
            ya, yb = kernel(*a), plain(*b)
            compare(name, dtype, shape, ya.detach(), yb.detach(), timer,
                    lambda: kernel(*inputs), lambda: plain(*inputs), moved, ops, lib)
            go = torch.randn_like(yb)
            ga = torch.autograd.grad(ya, a, go)
            gb = torch.autograd.grad(yb, b, go)
            err = max(float((x_.float() - y_.float()).abs().max()) for x_, y_ in zip(ga, gb))
            ok = ya.grad_fn is not None and err == 0.0
            emit({"phase": "kernels", "kernel": name, "gradient": "autograd Function wiring",
                  "dtype": str(dtype).replace("torch.", ""),
                  "shapes": [list(t.shape) for t in inputs],
                  "has_grad_fn": ya.grad_fn is not None, "max_abs_grad_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"{name}: gradient through the kernel's Function is off ({err})")
            del a, b, ya, yb, ga, gb


def sdpa_call(q, k, v):
    """One PyTorch call for causal GQA attention, as a yardstick only."""
    import torch.nn.functional as F

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def kernel_phase(dev, timer) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        es = torch.finfo(dtype).bits // 8
        # rmsnorm: the (B*S, d) sublayer norms and the (B*S*H, hd) q/k norms
        for rows_, d in ((B_PRE * S_PRE, D), (B_PRE * S_PRE * H, HD)):
            x, s = randn(rows_, d, dtype=dtype), randn(d, dtype=dtype)
            lib = (lambda x=x, s=s, d=d: F.rms_norm(x, (d,), s, 1e-5))
            r = compare("rmsnorm", dtype, [rows_, d], rmsnorm(x, s, 1e-5),
                        rmsnorm_plain(x, s, 1e-5), timer,
                        lambda: rmsnorm(x, s, 1e-5), lambda: rmsnorm_plain(x, s, 1e-5),
                        2 * x.numel() * es + d * es, 4.0 * x.numel(), lib)
            rows.setdefault(("rmsnorm", dtype), r)
        # swiglu over the FFN hidden
        g, u = randn(B_PRE * S_PRE, DFF, dtype=dtype), randn(B_PRE * S_PRE, DFF, dtype=dtype)
        rows[("swiglu", dtype)] = compare(
            "swiglu", dtype, [B_PRE * S_PRE, DFF], swiglu(g, u), swiglu_plain(g, u), timer,
            lambda: swiglu(g, u), lambda: swiglu_plain(g, u), 3 * g.numel() * es,
            5.0 * g.numel())
        # causal GQA prefill attention
        q = randn(B_PRE, S_PRE, H, HD, dtype=dtype)
        k, v = randn(B_PRE, S_PRE, KV, HD, dtype=dtype), randn(B_PRE, S_PRE, KV, HD, dtype=dtype)
        pairs = B_PRE * H * S_PRE * (S_PRE + 1) // 2  # (query, key) pairs the mask keeps
        rows[("flash_attention", dtype)] = compare(
            "flash_attention", dtype, [B_PRE, S_PRE, H, KV, HD],
            flash_attention(q, k, v), flash_attention_plain(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
            2 * nbytes(q) + 2 * nbytes(k), 4.0 * HD * pairs, sdpa_call(q, k, v))
        # paged decode over a shuffled pool, ragged lengths including 0
        n_pages = 1 + B_DEC * P_DEC
        qd = randn(B_DEC, 1, H, HD, dtype=dtype)
        kp, vp = randn(n_pages, PS, KV, HD, dtype=dtype), randn(n_pages, PS, KV, HD, dtype=dtype)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        tables = perm.reshape(B_DEC, P_DEC).to(torch.int32)
        lens = torch.tensor(DEC_LENS, dtype=torch.int32, device=dev)
        covered = sum(pages_needed(n, PS) * PS for n in DEC_LENS)  # KV rows the walk reads
        out = paged_decode(qd, kp, vp, tables, lens)
        rows[("paged_decode", dtype)] = compare(
            "paged_decode", dtype, [B_DEC, H, KV, HD, PS, P_DEC], out,
            paged_decode_plain(qd, kp, vp, tables, lens), timer,
            lambda: paged_decode(qd, kp, vp, tables, lens),
            lambda: paged_decode_plain(qd, kp, vp, tables, lens),
            2 * nbytes(qd) + 2 * covered * KV * HD * es + nbytes(tables, lens),
            4.0 * H * HD * sum(DEC_LENS))
        # the same logical KV in another physical layout: bitwise equal
        move = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1  # page p -> move[p-1]
        kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
        kp2[move], vp2[move] = kp[1:], vp[1:]
        kp2[0], vp2[0] = kp[0], vp[0]
        tables2 = move[(tables - 1).long()].to(torch.int32)
        out2 = paged_decode(qd, kp2, vp2, tables2, lens)
        zero_lanes = [i for i, n in enumerate(DEC_LENS) if n == 0]
        invariant = bool(torch.equal(out, out2))
        zeros = bool(torch.equal(out[zero_lanes], torch.zeros_like(out[zero_lanes])))
        emit({"phase": "kernels", "kernel": "paged_decode", "dtype": str(dtype).replace("torch.", ""),
              "layout_bitwise_invariant": invariant, "null_lanes_exact_zero": zeros})
        if not (invariant and zeros):
            raise AssertionError("paged decode: layout invariance or null lanes failed")
    rows.update(lowrank_rows(dev, timer, randn))
    train_shape_rows(timer, randn)
    torch.cuda.synchronize()
    return rows


def serve_phase(dev):
    cfg, params = run.build("qwen3-0.6b", device=dev, seed=0)
    workload = build_workload(SPEC)
    eng = ServeEngine(cfg, params, ECFG, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the serve run's own peak
    reset_launches()
    res = run.serve(eng, workload)
    torch.cuda.synchronize()
    launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
    per_prefill = {"rmsnorm": 4 * cfg.n_layers + 1, "swiglu": cfg.n_layers,
                   "flash_attention": cfg.n_layers, "paged_decode": 0}
    s = res.summary()
    emit({"phase": "serve", "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          **s, "decode_rounds": eng.decode_rounds,
          "decode_round_ms": 1e3 * eng.decode_wall_s / max(eng.decode_rounds, 1),
          "prefill_calls": eng.prefill_calls,
          "prefill_ms": 1e3 * eng.prefill_wall_s / max(eng.prefill_calls, 1),
          "launches": launches,
          "launches_per_decode_round": {n: (launches[n] - per_prefill[n] * eng.prefill_calls)
                                        / max(eng.decode_rounds, 1) for n in launches},
          "launches_per_prefill": per_prefill,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    # every layer: 4 norms (2 sublayers + q/k), 1 activation, 1 attention;
    # plus the final norm, per prefill call and per decode round alike
    L, calls = cfg.n_layers, eng.prefill_calls + eng.decode_rounds
    want = {"rmsnorm": (4 * L + 1) * calls, "swiglu": L * calls,
            "flash_attention": L * eng.prefill_calls, "paged_decode": L * eng.decode_rounds}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    for rs in res.states.values():
        if not rs.done or len(rs.emitted) != rs.req.max_new_tokens:
            raise AssertionError(f"request {rs.rid} emitted {len(rs.emitted)} of "
                                 f"{rs.req.max_new_tokens} tokens")
    if len(res.states) != SPEC.n_requests:
        raise AssertionError(f"{len(res.states)} of {SPEC.n_requests} requests served")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"the serve run never launched {missing}")
    return cfg, params, workload, launches


def path_logits(params, cfg, prompts, n_steps, forced=None):
    """Prefill each prompt into its own pages, then ``n_steps`` paged decode
    steps for all of them at once.  Returns (logits per step, tokens fed)."""
    dev = params["embed"].device
    dt = params["embed"].dtype
    n = len(prompts)
    P = pages_needed(max(len(p) for p in prompts) + n_steps + 1, PS)
    pool = init_pool(cfg, 1 + n * P, PS, dt, dev)
    tables = (torch.arange(n * P, device=dev, dtype=torch.int32) + 1).reshape(n, P)
    first = []
    for i, prompt in enumerate(prompts):
        n_pg = pages_needed(len(prompt), PS)
        toks = torch.zeros(1, n_pg * PS, dtype=torch.int32, device=dev)
        toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32, device=dev)
        dense, logits = forward_prefill(
            params, {"tokens": toks}, cfg, cache_structs(cfg, 1, n_pg * PS, dt),
            logit_pos=torch.tensor([len(prompt) - 1], device=dev))
        scatter_prefill(pool, dense, tables[i:i + 1, :n_pg], page_size=PS)
        first.append(logits[0])
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        pool, logits = forward_decode(params, pool, tok, lens, cfg, page_tables=tables,
                                      page_size=PS)
        out.append(logits)
        lens = lens + 1
    return torch.stack(out), fed


def parity_phase(dev, cfg, params, workload) -> None:
    prompts = [list(workload[0].prompt), list(workload[1].prompt)]
    f32_cfg, f32_params = run.build("qwen3-0.6b", device=dev, layers=4, dtype="float32",
                                    seed=1)
    # bf16: every layer rounds its norm, activation and attention outputs
    # to bf16 at places where the two paths can land one ulp (2^-8
    # relative) apart; over 28 layers such differences add up to a few
    # percent of the logits' scale, while a wrong kernel moves them by
    # their whole scale.  f32: only the summation order differs.
    checks = (("bfloat16", cfg, params, 2 ** -3, 2 ** -5),
              ("float32", f32_cfg, f32_params, 1e-4, None))
    for name, c, p, tol, mean_tol in checks:
        k_logits, fed = path_logits(p, c, prompts, 16)
        with plain_versions():
            p_logits, _ = path_logits(p, c, prompts, 16, forced=fed)
        diff = (k_logits - p_logits).abs()
        scale = float(p_logits.abs().max())
        max_err, mean_err = float(diff.max()), float(diff.mean())
        mean_ref = float(p_logits.abs().mean())
        if name == "bfloat16":
            ok = max_err <= tol * scale and mean_err <= mean_tol * mean_ref
            limit = {"max_abs_err <=": tol * scale, "mean_abs_err <=": mean_tol * mean_ref}
        else:
            ok = max_err <= tol
            limit = {"max_abs_err <=": tol}
        ok = ok and bool(torch.isfinite(k_logits).all())
        emit({"phase": "parity", "dtype": name, "n_layers": c.n_layers, "requests": [0, 1],
              "steps": 1 + len(fed), "max_abs_err": max_err, "mean_abs_err": mean_err,
              "max_abs_logit": scale, "mean_abs_logit": mean_ref, "limit": limit, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} path parity failed: max {max_err}, mean {mean_err}")


def train_launches_per_step(cfg, mode: str, flags: ExecFlags, mecefo: MeCeFOConfig) -> dict:
    """Kernel launches one training step must make: every layer's forward
    launches its norms (two sublayer norms, plus q/k norms with qk_norm), its
    activation and its attention; the FFN recompute (technique II or
    remat "ffn") launches the FFN norm and the activation again in the
    backward; the final norm launches once; each of the three low-rank FFN
    matmuls launches kernel #6 once in the backward unless the step is
    exact.  The backwards of the norm, activation and attention recompute
    their plain versions and launch nothing."""
    if flags.remat not in ("none", "ffn"):
        raise ValueError(f"no launch count derived for remat {flags.remat!r}")
    L = cfg.n_layers
    recompute = flags.remat == "ffn" or (mode == "degraded" and mecefo.recompute_ffn)
    exact = NDBContext(mode=mode, mecefo=mecefo).lowrank_mode() == "exact"
    return {
        "rmsnorm": (2 + 2 * cfg.qk_norm + recompute) * L + 1,
        "swiglu": (1 + recompute) * L,
        "flash_attention": L,
        "lowrank_wgrad": 0 if exact else 3 * L,
    }


def train_phase(dev):
    cell = train_cell(dev)  # V1 refreshed before the first step
    cfg = cell.cfg
    src = cell.source()
    batches = [src.batch(i, TRAIN_B, TRAIN_S) for i in range(TRAIN_STEPS)]
    out = {}
    total = {n: 0 for n in TRAIN_KERNELS}
    for mode in TRAIN_MODES:
        state = cell.state()
        step, ndb = cell.step(mode, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset_launches()
        losses, times = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[i], *ndb)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
        launches = {n: WRAPPERS[n].launches for n in TRAIN_KERNELS}
        want = train_launches_per_step(cfg, mode, TRAIN_FLAGS, cell.mecefo)
        per_step = {n: launches[n] / TRAIN_STEPS for n in TRAIN_KERNELS}
        med = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated()
        ok = per_step == want and bool(np.isfinite([*losses, gnorm]).all())
        emit({"phase": "train", "config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
              "mode": mode, "batch": TRAIN_B, "seq_len": TRAIN_S, "rank": TRAIN_RANK,
              "remat": TRAIN_FLAGS.remat, "losses": losses, "last_grad_norm": gnorm,
              "step_ms": [1e3 * t for t in times], "step_ms_median": 1e3 * med,
              "tokens_per_s": TRAIN_B * TRAIN_S / med, "peak_mem_gib": peak / 2 ** 30,
              "peak_above_state_gib": (peak - base_mem) / 2 ** 30,
              "launches_per_step": per_step, "want_launches_per_step": want,
              "svd_refresh_s": cell.svd_s, "ok": ok})
        if not ok:
            raise AssertionError(f"train {mode}: launches {per_step} (want {want}), "
                                 f"losses {losses}, grad norm {gnorm}")
        for n in TRAIN_KERNELS:
            total[n] += launches[n]
        out[mode] = peak
        del state, step
    if not out["degraded"] < out["off"]:
        raise AssertionError(f"degraded peak memory {out['degraded']} not below off {out['off']}")
    missing = [n for n, c in total.items() if c == 0]
    if missing:
        raise AssertionError(f"the train run never launched {missing}")
    return total


def leaf_rel_errs(ga, gb) -> list:
    """Per gradient leaf, ||a - b|| / ||b||."""
    return [float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
            for a, b in zip(tree_leaves(ga), tree_leaves(gb))]


def parity_ctx(mode: str, keep, w, dev) -> NDBContext:
    mecefo = MeCeFOConfig(mode="dynamic", rank=TRAIN_RANK)
    if mode in ("off", "degraded"):
        return NDBContext(mode=mode, mecefo=mecefo)
    return NDBContext(mode=mode, keep=torch.as_tensor(keep, device=dev),
                      example_weight=torch.as_tensor(w, device=dev), mecefo=mecefo)


def train_parity_phase(dev) -> None:
    """One step's loss and gradients through the kernels and through the
    plain versions, with the train phase's flags (FFN recompute): in bf16
    at full depth in dynamic and degraded mode, in f32 on a 4-layer copy in
    all four modes.  In bf16 both are also held against the same step in
    f32 (plain versions, the same weights upcast): the kernel path may be
    no farther from it than TRAIN_ANCHOR_RATIO times the plain bf16 path
    is."""
    full = get_config(TRAIN_CONFIG)
    checks = (("bfloat16", full, ("dynamic", "degraded")),
              ("float32", dataclasses.replace(full, n_layers=4, dtype="float32"), TRAIN_MODES))
    for dtype, cfg, modes in checks:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
        proj = refresh_projections(params, cfg, TRAIN_RANK)
        keep, w = plan_to_masks(TRAIN_PLAN, cfg, TRAIN_B)
        batch = to_device(SyntheticLM(cfg.vocab_size).batch(0, TRAIN_B, TRAIN_S), dev)
        for mode in modes:
            ctx = parity_ctx(mode, keep, w, dev)
            lk, _, gk = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
            with plain_versions():
                lp, _, gp = loss_and_grads(params, proj, batch, cfg, ctx, TRAIN_FLAGS)
            rel = leaf_rel_errs(gk, gp)
            tol, loss_tol = TRAIN_PARITY_TOL[dtype]
            loss_err = abs(float(lk) - float(lp))
            ok = (max(rel) <= tol and loss_err <= loss_tol * abs(float(lp))
                  and all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk)))
            row = {"phase": "train parity", "dtype": dtype, "n_layers": cfg.n_layers,
                   "mode": mode, "remat": TRAIN_FLAGS.remat, "loss_kernels": float(lk),
                   "loss_plain": float(lp), "loss_abs_err": loss_err, "loss_limit_rel": loss_tol,
                   "max_leaf_rel_err": max(rel), "mean_leaf_rel_err": sum(rel) / len(rel),
                   "n_leaves": len(rel), "limit_rel": tol}
            if dtype == "bfloat16":
                cfg32 = dataclasses.replace(cfg, dtype="float32")
                up = lambda t: t.float()  # noqa: E731
                with plain_versions():
                    _l32, _, g32 = loss_and_grads(tree_map(up, params), tree_map(up, proj), batch,
                                                  cfg32, ctx, TRAIN_FLAGS)
                to_k, to_p = max(leaf_rel_errs(gk, g32)), max(leaf_rel_errs(gp, g32))
                ok = ok and to_k <= TRAIN_ANCHOR_RATIO * to_p
                row.update({"max_leaf_rel_err_kernels_vs_f32": to_k,
                            "max_leaf_rel_err_plain_vs_f32": to_p,
                            "anchor_ratio_limit": TRAIN_ANCHOR_RATIO})
                del g32
            emit(dict(row, ok=ok))
            if not ok:
                raise AssertionError(f"{dtype} {mode} train parity failed: {row}")
            del gk, gp
            torch.cuda.empty_cache()
        del params, proj


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "sources": sorted(logs),
          "registers": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
                        for n, log in logs.items()}})

    timer = ColdTimer(dev)
    rows = kernel_phase(dev, timer)
    cfg, params, workload, launches = serve_phase(dev)
    parity_phase(dev, cfg, params, workload)
    del cfg, params, workload
    torch.cuda.empty_cache()
    # each kernel's launches from its own path: the four serving kernels
    # from the serve run, kernel #6 from the training run
    launches["lowrank_wgrad"] = train_phase(dev)["lowrank_wgrad"]
    train_parity_phase(dev)

    emit({"kernels": [
        {"name": n, "route": "cuda", "source": f"src/repro_torch/csrc/{n}.cu",
         "replaces": REPLACES[n], "launches": launches[n],
         **{k: rows[(n, torch.bfloat16)][k] for k in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for n in WRAPPERS
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
