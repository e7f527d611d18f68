#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU and ``nvcc``; exits non-zero without them.  Phases,
each printing one JSON line:

1. build   — compile every kernel from ``src/repro_torch/csrc`` (one nvcc
             per source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card at
             the serving path's shapes, in bf16 and f32, with its time, the
             plain version's time, its bound and (where one PyTorch call
             computes the same function) that call's time; the paged decode
             also bitwise-invariant to the physical page layout, with exact
             zeros on length-0 lanes.
3. serve   — full-width qwen3-0.6b (bf16, seeded weights) serves 16 seeded
             requests to completion through the port's engine; every
             kernel's launch count must grow during that run.
4. parity  — two of those requests, prefill and 16 decode steps, through
             the kernels and through the plain versions (teacher-forced with
             the kernel path's tokens), in bf16 at full depth and in f32 on a
             4-layer full-width copy.

Then the kernels' summary line, the card's name and power limit, and the
final ``{"ok": true, ...}`` line.  Any failed check raises.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.swiglu import swiglu, swiglu_plain  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import forward_decode, forward_prefill  # noqa: E402
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
}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:22",
    "swiglu": "src/repro/kernels/swiglu.py:20",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "paged_decode": "src/repro/kernels/paged_decode.py:51",
}

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
    torch.cuda.synchronize()
    return rows


def serve_phase(dev):
    cfg, params = run.build("qwen3-0.6b", device=dev, seed=0)
    workload = build_workload(SPEC)
    eng = ServeEngine(cfg, params, ECFG, device=dev)
    reset_launches()
    res = run.serve(eng, workload)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in WRAPPERS.items()}
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


def path_logits(params, cfg, prompts, n_steps, plain, forced=None):
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
            logit_pos=torch.tensor([len(prompt) - 1], device=dev), plain=plain)
        scatter_prefill(pool, dense, tables[i:i + 1, :n_pg], page_size=PS)
        first.append(logits[0])
    out = [torch.stack(first)]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    fed = []
    for step in range(n_steps):
        tok = greedy_token(out[-1], cfg) if forced is None else forced[step]
        fed.append(tok)
        pool, logits = forward_decode(params, pool, tok, lens, cfg, page_tables=tables,
                                      page_size=PS, plain=plain)
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
        k_logits, fed = path_logits(p, c, prompts, 16, plain=False)
        p_logits, _ = path_logits(p, c, prompts, 16, plain=True, forced=fed)
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
