"""Where a serve run's time goes on the card.

    PYTHONPATH=src python -m repro_torch.serve.profile --config qwen3-0.6b [--paged-kernel]

Serves the same seeded workload as :mod:`repro_torch.serve.run` (with the
same engine flags) once to warm up, then again under ``torch.profiler``
(CPU and CUDA activities), and prints one JSON line: the wall time of the
profiled run, the device time summed over all kernels, the device busy and
idle shares, the engine's own decode and prefill wall times, and the
kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.serve import run
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.request import WorkloadSpec, build_workload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=run.DEFAULT_CONFIG)
    run.add_engine_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg, params = run.build(args.config, device=dev)
    ecfg = run.engine_config(args)
    spec = WorkloadSpec(n_requests=16, vocab_size=cfg.vocab_size,
                        prompt_len=(64, 512), new_tokens=(16, 64), seed=0)
    run.serve(ServeEngine(cfg, params, ecfg, device=dev), build_workload(spec))  # warm-up
    eng = ServeEngine(cfg, params, ecfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run.serve(eng, build_workload(spec))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e) -> float:
        return float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    out = {
        "config": cfg.name, "n_layers": cfg.n_layers,
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "n_tokens": res.summary()["n_tokens"],
        "device_kernel_s": kernel_us / 1e6,
        "device_busy_share": kernel_us / 1e6 / wall,
        "device_idle_share": 1.0 - kernel_us / 1e6 / wall,
        "decode": "paged" if ecfg.use_paged_kernel else "dense",
        "decode_rounds": res.accounting["decode_rounds"], "decode_wall_s": eng.decode_wall_s,
        "prefill_calls": eng.prefill_calls, "prefill_wall_s": eng.prefill_wall_s,
        "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_s": dev_us(e) / 1e6}
                        for e in top],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
