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
             layout, with exact zeros on length-0 lanes; the dense flash
             decode (kernel #5) with exact zeros on length-0 lanes, right
             on a ragged Smax, and bitwise equal to the paged decode over a
             gather_pages view of a shuffled pool; the low-rank Wgrad
             bitwise repeatable, and its limit shown to catch a kernel that
             rounds x @ V1 to bf16; the flash attention's bf16 output within
             half a bf16 ulp (plus a stated slack) of the f32 function, a
             limit shown to catch P rounded to bf16; #2 and #6 timed in turns
             against their library call (kernel, call, call, kernel; three
             rounds; the median factor); the norm, activation and attention
             kernels also at the training path's shapes, where each
             autograd Function's gradient must equal the plain version's
             (a check of the wiring: the backward recomputes the plain
             version).
3. serve   — full-width qwen3-0.6b (bf16, seeded weights) serves 16 seeded
             requests to completion through the port's engine on the paged
             decode round; launch counts must be exactly those the engine's
             calls imply.
4. serve dense — the same requests on the default dense decode round
             (gather_pages, kernel #5, scatter_token): launch counts exact
             (kernel #5 28 per round, the paged kernel none), token streams
             identical to the paged run's, its round time, tok/s and peak
             memory.
5. serve chunk/share — the same model with chunked prefill (8 pages) and
             prefix sharing on a seeded workload of two 128-token shared
             prefixes: every request completes, prefixes are hit, chunks run,
             launch counts are exact; two requests sharing a prefix go
             through chunked prefill, a forked prefix and 16 dense decode
             steps through the kernels and through the plain versions
             (teacher-forced), held at the parity phase's bf16 limits.
6. parity  — two of the serve requests, prefill and 16 paged decode steps,
             through the kernels and through the plain versions
             (teacher-forced with the kernel path's tokens), in bf16 at full
             depth and in f32 on a 4-layer full-width copy.
7. train   — full-width, full-depth llama-350m (bf16, seeded weights, B=8,
             S=1024, rank 64, FFN recompute) takes 3 MeCeFO training steps in
             each NDB mode (off, dynamic, static, degraded) under the plan
             NDBPlan(n_dp=4, n_stages=8, failed={(1, 3)}); one line per mode
             with losses, step time, tokens/s, peak memory and launches per
             step.  Launch counts must match the ones derived from the model,
             the losses be finite, and the degraded step's peak memory lie
             below the healthy one's.
8. train parity — one step's loss and gradients through the kernels and
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
import re
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ROUND_SLACK, flash_attention, flash_attention_plain, rounding_ratio,
)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain  # noqa: E402
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
from repro_torch.models.model import (  # noqa: E402
    ExecFlags, forward_decode, forward_prefill, forward_prefill_chunk,
)
from repro_torch.models.params import init_params, tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.kvpool import (  # noqa: E402
    gather_pages, init_pool, pages_needed, scatter_pages, scatter_prefill, scatter_token,
)
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
    "lowrank_wgrad": lowrank_wgrad_project, "flash_decode": flash_decode,
}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
    "swiglu": "src/repro/kernels/swiglu.py:20",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "paged_decode": "src/repro/kernels/paged_decode.py:51",
    "lowrank_wgrad": "src/repro/kernels/lowrank_wgrad.py:44",
    "flash_decode": "src/repro/kernels/flash_decode.py:70",
}
SERVE_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "paged_decode", "flash_decode")
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
# kernel #5 at the dense round's shapes: the dense view is (B_DEC, P_DEC *
# PS) rows, walked in page-sized blocks; and a ragged Smax
SMAX_DEC, SMAX_RAGGED = P_DEC * PS, 1000
BLOCK_SWEEP = (16, 32, 64, 128)
ECFG = EngineConfig(max_slots=8, page_size=16, pages_per_slot=64)
PAGED_ECFG = dataclasses.replace(ECFG, use_paged_kernel=True)
SPEC = WorkloadSpec(n_requests=16, vocab_size=151936, prompt_len=(64, 512),
                    new_tokens=(16, 64), seed=0)
# chunked prefill and prefix sharing: two 128-token system prompts
CHUNK_PAGES = 8
SHARE_ECFG = dataclasses.replace(ECFG, prefill_chunk_pages=CHUNK_PAGES, prefix_sharing=True)
SHARE_SPEC = dataclasses.replace(SPEC, shared_prefix=128, n_prefix_groups=2)
# path parity in bf16 (parity and chunk/share phases): every layer rounds
# its norm, activation and attention outputs to bf16 at places where the
# two paths can land one ulp (2^-8 relative) apart; over 28 layers such
# differences add up to a few percent of the logits' scale, while a wrong
# kernel moves them by their whole scale.  (max |Δ| / max |logit|, mean
# |Δ| / mean |logit|)
BF16_PATH_TOL = (2 ** -3, 2 ** -5)


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


def turns(name, shape, timer, call_k, call_lib, rounds: int = 3) -> dict:
    """The kernel against its library call in turns (kernel, call, call,
    kernel), ``rounds`` times, each time a cold median: kernel times move
    several-fold between calls, so the factor is read inside one call."""
    times, factors = [], []
    for _ in range(rounds):
        k1, l1, l2, k2 = timer(call_k), timer(call_lib), timer(call_lib), timer(call_k)
        times.append([k1, l1, l2, k2])
        factors.append((k1 + k2) / (l1 + l2))
    row = {"phase": "kernels", "kernel": name, "dtype": "bfloat16", "shape": shape,
           "turns_ms": times, "factors": factors,
           "median_factor": sorted(factors)[len(factors) // 2]}
    emit(row)
    return row


def flash_rounding_row(q, k, v, shape) -> None:
    """Kernel #2's bf16 output against the f32 function (the plain version
    on the inputs cast to f32): every element within half a bf16 ulp plus
    ROUND_SLACK of the magnitude of its terms (``rounding_ratio`` <= 1).  The
    control, the plain version with P rounded to bf16 before PV, must fall
    outside; the row prints by how much."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    y = flash_attention_plain(q32, k32, v32)
    mag = flash_attention_plain(q32, k32, v32.abs())
    ratio = rounding_ratio(flash_attention(q, k, v), y, mag)
    control = rounding_ratio(flash_attention_plain(q, k, v, p_precision="bf16"), y, mag)
    ok = float(ratio.max()) <= 1.0
    caught = float(control.max()) > 1.0
    emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "bfloat16", "shape": shape,
          "rounding": "half bf16 ulp + slack x magnitude", "slack": ROUND_SLACK,
          "max_ratio": float(ratio.max()), "n_over": int((ratio > 1).sum()), "ok": ok,
          "control_p_in_bf16_max_ratio": float(control.max()),
          "control_n_over": int((control > 1).sum()), "n": ratio.numel(),
          "control_caught": caught})
    if not ok:
        raise AssertionError(f"flash attention {shape}: bf16 output off the f32 function by "
                             f"{float(ratio.max())} of the rounding limit")
    if not caught:
        raise AssertionError(f"flash attention {shape}: the rounding limit passes a P rounded "
                             f"to bf16 ({float(control.max())})")


def ptxas_info(log: str) -> list:
    """Per compiled kernel, from ``-Xptxas -v``: [mangled name, registers,
    spill store bytes, spill load bytes]."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = [m.group(1), None, None, None]
            out.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                                 r"spill loads", ln)):
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur[1] = int(m.group(1))
    return out


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
            control = float((lowrank_wgrad_project_plain(x, dy, v1, p_precision="bf16")
                             - ref).abs().max())
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
            if dtype == torch.bfloat16 and T >= 8192:  # the main path's shapes
                turns("lowrank_wgrad", [T, n, m, r], timer,
                      lambda: lowrank_wgrad_project(x, dy, v1),
                      lambda: torch.linalg.multi_dot([v1.T, x.T, dy]))
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
            if name == "flash_attention" and dtype == torch.bfloat16:
                flash_rounding_row(q, k, v, shape)
                turns(name, shape, timer, lambda: kernel(*inputs), lib)
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


def sdpa_decode_call(q, k, v, lens):
    """One PyTorch call for length-masked GQA decode attention, as a
    yardstick only (a length-0 lane gives NaN there, 0 in the kernel)."""
    import torch.nn.functional as F

    mask = torch.arange(k.shape[1], device=q.device)[None, :] < lens.long()[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None, None, :],
                                                  enable_gqa=True)


def flash_decode_rows(dtype, timer, randn, qd, lens, paged_out, kp, vp, tables) -> dict:
    """Kernel #5 at the dense round's shapes (B_DEC lanes of SMAX_DEC rows,
    page-sized blocks, the paged rows' lengths); exact zeros on length-0
    lanes; a ragged Smax; bitwise equal to kernel #1 over a gather_pages
    view of the paged rows' shuffled pool.  Returns the timed row."""
    es = torch.finfo(dtype).bits // 8
    kd, vd = (randn(B_DEC, SMAX_DEC, KV, HD, dtype=dtype) for _ in range(2))
    out = flash_decode(qd, kd, vd, lens, block_k=PS)
    row = compare(
        "flash_decode", dtype, [B_DEC, SMAX_DEC, H, KV, HD, PS], out,
        flash_decode_plain(qd, kd, vd, lens), timer,
        lambda: flash_decode(qd, kd, vd, lens, block_k=PS),
        lambda: flash_decode_plain(qd, kd, vd, lens),
        # q read, o written, and the K/V rows below each lane's length
        2 * nbytes(qd) + 2 * sum(DEC_LENS) * KV * HD * es + nbytes(lens),
        4.0 * H * HD * sum(DEC_LENS), sdpa_decode_call(qd, kd, vd, lens))
    zero_lanes = lens == 0
    zeros = bool(torch.equal(out[zero_lanes], torch.zeros_like(out[zero_lanes])))
    # a ragged Smax: the last block holds SMAX_RAGGED % PS rows
    kr, vr = kd[:, :SMAX_RAGGED].contiguous(), vd[:, :SMAX_RAGGED].contiguous()
    lens_r = lens.clamp(max=SMAX_RAGGED)
    ref_r = flash_decode_plain(qd, kr, vr, lens_r).float()
    err_r = (flash_decode(qd, kr, vr, lens_r, block_k=PS).float() - ref_r).abs()
    atol, rtol = TOL[dtype]
    ragged_ok = bool((err_r <= atol + rtol * ref_r.abs()).all())
    view = gather_pages(({"k": kp[None], "v": vp[None]},), tables, page_size=PS)[0]
    bitwise = bool(torch.equal(flash_decode(qd, view["k"][0], view["v"][0], lens, block_k=PS),
                               paged_out))
    emit({"phase": "kernels", "kernel": "flash_decode", "dtype": row["dtype"],
          "null_lanes_exact_zero": zeros, "ragged_smax": SMAX_RAGGED,
          "ragged_max_abs_err": float(err_r.max()), "ragged_ok": ragged_ok,
          "bitwise_equal_paged_decode_over_gather_pages_view": bitwise})
    if not (zeros and ragged_ok and bitwise):
        raise AssertionError(f"flash decode {dtype}: null lanes {zeros}, ragged Smax "
                             f"{ragged_ok}, bitwise vs paged {bitwise}")
    if dtype == torch.bfloat16:  # the block size the dense round does not fix
        emit({"phase": "kernels", "kernel": "flash_decode", "dtype": row["dtype"],
              "block_k_sweep_ms": {bk: timer(lambda bk=bk: flash_decode(qd, kd, vd, lens,
                                                                        block_k=bk))
                                   for bk in BLOCK_SWEEP}})
    return row


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
        if dtype == torch.bfloat16:
            flash_rounding_row(q, k, v, [B_PRE, S_PRE, H, KV, HD])
            turns("flash_attention", [B_PRE, S_PRE, H, KV, HD], timer,
                  lambda: flash_attention(q, k, v), sdpa_call(q, k, v))
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
        rows[("flash_decode", dtype)] = flash_decode_rows(dtype, timer, randn, qd, lens, out,
                                                          kp, vp, tables)
    rows.update(lowrank_rows(dev, timer, randn))
    train_shape_rows(timer, randn)
    torch.cuda.synchronize()
    return rows


def serve_run(dev, cfg, params, ecfg, workload):
    """Serve ``workload`` to completion on a fresh engine; returns (engine,
    result, launches per kernel, the run's own peak memory in GiB)."""
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = run.serve(eng, workload)
    torch.cuda.synchronize()
    launches = {n: WRAPPERS[n].launches for n in SERVE_KERNELS}
    return eng, res, launches, torch.cuda.max_memory_allocated() / 2 ** 30


def check_serve(phase, cfg, ecfg, workload, eng, res, launches, peak, must_launch, **extra):
    """Emit the run's line and hold it to its launch counts (every layer: 4
    norms (2 sublayers + q/k), 1 activation, 1 attention; plus the final
    norm, per batched prefill, prompt chunk and decode round alike; the
    chunks' attention is plain history attention), to launching every
    kernel of ``must_launch`` and to completing every request."""
    L = cfg.n_layers
    rounds = res.accounting["decode_rounds"]
    calls = eng.prefill_calls + eng.chunk_calls + rounds
    paged = ecfg.use_paged_kernel
    want = {"rmsnorm": (4 * L + 1) * calls, "swiglu": L * calls,
            "flash_attention": L * eng.prefill_calls,
            "paged_decode": L * rounds if paged else 0,
            "flash_decode": 0 if paged else L * rounds}
    s = res.summary()
    emit({"phase": phase, "config": cfg.name, "n_layers": L, "dtype": cfg.dtype,
          "decode": "paged" if paged else "dense", **s, **res.accounting,
          "decode_round_ms": 1e3 * eng.decode_wall_s / max(rounds, 1),
          "prefill_calls": eng.prefill_calls, "chunk_calls": eng.chunk_calls,
          "prefill_ms_per_call": 1e3 * eng.prefill_wall_s
          / max(eng.prefill_calls + eng.chunk_calls, 1),
          "launches": launches, "want_launches": want, "peak_mem_gib": peak, **extra})
    if launches != want:
        raise AssertionError(f"{phase}: launch counts {launches}, want {want}")
    missing = [n for n in must_launch if launches[n] == 0]
    if missing:
        raise AssertionError(f"{phase}: the run never launched {missing}")
    for rs in res.states.values():
        if not rs.done or len(rs.emitted) != rs.req.max_new_tokens:
            raise AssertionError(f"{phase}: request {rs.rid} emitted {len(rs.emitted)} of "
                                 f"{rs.req.max_new_tokens} tokens")
    if len(res.states) != len(workload):
        raise AssertionError(f"{phase}: {len(res.states)} of {len(workload)} requests served")


def serve_phase(dev):
    """The paged round, then the dense round on the same requests."""
    cfg, params = run.build("qwen3-0.6b", device=dev, seed=0)
    workload = build_workload(SPEC)
    eng, res, launches, peak = serve_run(dev, cfg, params, PAGED_ECFG, workload)
    check_serve("serve", cfg, PAGED_ECFG, workload, eng, res, launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "paged_decode"))
    paged_streams = res.streams()
    del eng, res  # the paged engine's pool must not count in the dense run's peak
    eng, res, dense_launches, peak = serve_run(dev, cfg, params, ECFG, workload)
    same = res.streams() == paged_streams
    check_serve("serve dense", cfg, ECFG, workload, eng, res, dense_launches, peak,
                ("rmsnorm", "swiglu", "flash_attention", "flash_decode"),
                streams_equal_paged=same)
    if not same:
        raise AssertionError("serve dense: token streams differ from the paged round's")
    launches["flash_decode"] = dense_launches["flash_decode"]
    return cfg, params, workload, launches


def chunk_share_logits(params, cfg, prompts, n_shared, n_steps, forced=None):
    """Two prompts through the chunk-and-share path: the first prefilled in
    chunks of CHUNK_PAGES pages; the second forks the first's pages below
    ``n_shared`` and prefills only its tail in chunks; then ``n_steps``
    dense decode rounds (gather_pages, kernel #5, scatter_token) for both.
    Returns (logits per step, tokens fed)."""
    dev, dt = params["embed"].device, params["embed"].dtype
    P = pages_needed(max(len(p) for p in prompts) + n_steps + 1, PS)
    n_fork = n_shared // PS
    pool = init_pool(cfg, 1 + 2 * P, PS, dt, dev)
    pages = torch.arange(1, 2 * P + 1, dtype=torch.int32, device=dev)
    tables = torch.stack([pages[:P], torch.cat([pages[:n_fork], pages[P:2 * P - n_fork]])])
    first = []
    for i, prompt in enumerate(prompts):
        off = n_fork * PS if i else 0
        while off < len(prompt):
            end = min(len(prompt), (off // PS + CHUNK_PAGES) * PS)
            pg_lo, pg_hi = off // PS, pages_needed(end, PS)
            toks = torch.zeros(1, pg_hi * PS - off, dtype=torch.int32, device=dev)
            toks[0, :end - off] = torch.tensor(prompt[off:end], dtype=torch.int32, device=dev)
            dense = gather_pages(pool, tables[i:i + 1], page_size=PS)
            dense, logits = forward_prefill_chunk(params, dense, {"tokens": toks}, off, cfg,
                                                  end - off - 1)
            scatter_pages(pool, dense, tables[i, pg_lo:pg_hi], pg_lo=pg_lo, n_pg=pg_hi - pg_lo,
                          page_size=PS)
            off = end
        first.append(logits[0])
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        dense = gather_pages(pool, tables, page_size=PS)
        dense, logits = forward_decode(params, dense, tok, lens, cfg, page_size=PS)
        scatter_token(pool, dense, tables, lens, page_size=PS)
        out.append(logits)
        lens = lens + 1
    return torch.stack(out), fed


def hold_bf16_path(phase, k_logits, p_logits, **extra) -> None:
    """Kernel path against plain path in bf16, at BF16_PATH_TOL."""
    diff = (k_logits - p_logits).abs()
    scale, mean_ref = float(p_logits.abs().max()), float(p_logits.abs().mean())
    max_err, mean_err = float(diff.max()), float(diff.mean())
    tol, mean_tol = BF16_PATH_TOL
    ok = (max_err <= tol * scale and mean_err <= mean_tol * mean_ref
          and bool(torch.isfinite(k_logits).all()))
    emit({"phase": phase, "dtype": "bfloat16", **extra, "max_abs_err": max_err,
          "mean_abs_err": mean_err, "max_abs_logit": scale, "mean_abs_logit": mean_ref,
          "limit": {"max_abs_err <=": tol * scale, "mean_abs_err <=": mean_tol * mean_ref},
          "ok": ok})
    if not ok:
        raise AssertionError(f"{phase} bf16 path parity failed: max {max_err}, mean {mean_err}")


def chunk_share_phase(dev, cfg, params) -> None:
    workload = build_workload(SHARE_SPEC)
    eng, res, launches, peak = serve_run(dev, cfg, params, SHARE_ECFG, workload)
    check_serve("serve chunk/share", cfg, SHARE_ECFG, workload, eng, res, launches, peak,
                ("rmsnorm", "swiglu", "flash_decode"))
    if not (res.accounting["n_prefix_hits"] > 0 and eng.chunk_calls > 0):
        raise AssertionError(f"serve chunk/share: prefix hits {res.accounting['n_prefix_hits']},"
                             f" chunks {eng.chunk_calls}")
    # two requests of one prefix group
    head = SHARE_SPEC.shared_prefix
    by_group = {}
    for req in workload:
        by_group.setdefault(tuple(req.prompt[:head]), []).append(list(req.prompt))
    prompts = next(g[:2] for g in by_group.values() if len(g) >= 2)
    k_logits, fed = chunk_share_logits(params, cfg, prompts, head, 16)
    with plain_versions():
        p_logits, _ = chunk_share_logits(params, cfg, prompts, head, 16, forced=fed)
    hold_bf16_path("serve chunk/share parity", k_logits, p_logits, n_layers=cfg.n_layers,
                   prompt_lens=[len(p) for p in prompts], shared=head, steps=1 + len(fed))


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
    k_logits, fed = path_logits(params, cfg, prompts, 16)
    with plain_versions():
        p_logits, _ = path_logits(params, cfg, prompts, 16, forced=fed)
    hold_bf16_path("parity", k_logits, p_logits, n_layers=cfg.n_layers, requests=[0, 1],
                   steps=1 + len(fed))
    # f32: only the summation order differs
    k_logits, fed = path_logits(f32_params, f32_cfg, prompts, 16)
    with plain_versions():
        p_logits, _ = path_logits(f32_params, f32_cfg, prompts, 16, forced=fed)
    max_err = float((k_logits - p_logits).abs().max())
    ok = max_err <= 1e-4 and bool(torch.isfinite(k_logits).all())
    emit({"phase": "parity", "dtype": "float32", "n_layers": f32_cfg.n_layers, "requests": [0, 1],
          "steps": 1 + len(fed), "max_abs_err": max_err,
          "max_abs_logit": float(p_logits.abs().max()), "limit": {"max_abs_err <=": 1e-4},
          "ok": ok})
    if not ok:
        raise AssertionError(f"float32 path parity failed: max {max_err}")


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
          "kernels_registers_spills": {n: ptxas_info(log) for n, log in logs.items()}})

    timer = ColdTimer(dev)
    rows = kernel_phase(dev, timer)
    cfg, params, workload, launches = serve_phase(dev)
    chunk_share_phase(dev, cfg, params)
    parity_phase(dev, cfg, params, workload)
    del cfg, params, workload
    torch.cuda.empty_cache()
    # each kernel's launches from its own path: the paged serve run's for
    # #1-#4, the dense serve run's for #5, the training run's for #6
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
