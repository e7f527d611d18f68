"""Where a serve run's time goes on the card.

    PYTHONPATH=src python -m repro_torch.serve.profile --config qwen3-0.6b [--paged-kernel]

Serves the serve cell's seeded workload (16 requests, prompts 64-512, 16-64
new tokens; ``chip_smoke.py``'s serve phases) on one engine through
:func:`repro_torch.serve.run.serve` once to warm up, then again under
``torch.profiler``
(CPU and CUDA activities), and prints one JSON line: the wall time of the
profiled run, the device time summed over all kernels, the device busy and
idle shares, the engine's own decode and prefill wall times, the kernels
that take the most device time, and each of the port's kernels' device time
and share of it.  The decode kernels' combine pass is launched with
programmatic dependence on their split pass and waits for it on the card, so
its span overlaps the split pass's: the sum over kernels counts that overlap
twice.  The profiled run also labels the model's parts (the attention
sublayer, and an MoE layer's routing and dispatch, experts and combine) with
``torch.profiler.record_function`` ranges and reports each part's device
time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import resolve_device
from repro_torch.models import layers, moe
from repro_torch.obs.catalog import TRACED_SPAN_SET
from repro_torch.serve import run
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.request import WorkloadSpec, build_workload

# the port's kernels by the names of their CUDA functions (csrc/*.cu); the
# decode kernels' split passes by their row policy, their shared combine pass
PORT_KERNELS = {"paged_decode": "PagedRows>", "flash_decode": "DenseRows",
                "decode_combine": "decode::combine_kernel", "flash_attention": "flash_fwd_",
                "rmsnorm": "rmsnorm_", "swiglu": "swiglu_kernel",
                "swiglu_bwd": "swiglu_bwd_kernel"}


# the model's parts: (module, function) the profiled run labels
PARTS = {"attention": (layers, "_attention"), "moe routing and dispatch": (moe, "dispatch"),
         "moe experts": (moe, "experts"), "moe combine": (moe, "combine")}


@contextlib.contextmanager
def labelled_parts():
    """Each function of :data:`PARTS` runs inside a ``record_function``
    range of its part's name while the block runs."""
    saved = {}
    for label, (mod, name) in PARTS.items():
        fn = getattr(mod, name)
        saved[label] = fn

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for label, (mod, name) in PARTS.items():
            setattr(mod, name, saved[label])


def _dev_us(e) -> float:
    return float(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)))


def _kernels(events) -> list:
    """A profile's CUDA kernels: its device entries without the mirrors of
    the labelled parts and of the spans (``obs/spans.py``) on the device's
    timeline (first kernel to last, gaps included), which are annotations,
    not device work."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in PARTS and e.key not in TRACED_SPAN_SET]


def profile_serve(eng: ServeEngine, workload) -> dict:
    """Serve ``workload`` on ``eng`` under ``torch.profiler``; the device
    busy and idle shares, the top kernels, each port kernel's device time
    and share, and each labelled part's kernel time and device-side span."""
    torch.cuda.synchronize()
    with labelled_parts(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run.serve(eng, workload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = _kernels(events)
    kernel_us = sum(_dev_us(e) for e in kernels)
    top = sorted(kernels, key=_dev_us, reverse=True)[:12]

    def port(tag: str) -> dict:
        mine = [e for e in kernels if tag in e.key]
        us = sum(_dev_us(e) for e in mine)
        return {"calls": sum(e.count for e in mine), "device_s": us / 1e6,
                "share": us / kernel_us if kernel_us else 0.0}

    out = {
        "config": eng.cfg.name, "n_layers": eng.cfg.n_layers,
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "n_tokens": res.summary()["n_tokens"],
        "device_kernel_s": kernel_us / 1e6,
        "device_busy_share": kernel_us / 1e6 / wall,
        "device_idle_share": 1.0 - kernel_us / 1e6 / wall,
        "decode": "paged" if eng.ecfg.use_paged_kernel else "dense",
        "decode_rounds": res.accounting["decode_rounds"], "decode_wall_s": eng.decode_wall_s,
        "prefill_calls": eng.prefill_calls, "prefill_wall_s": eng.prefill_wall_s,
        "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_s": _dev_us(e) / 1e6}
                        for e in top],
        "port_kernels": {name: port(tag) for name, tag in PORT_KERNELS.items()},
    }
    # a part's kernel time: the device time of the kernels launched inside
    # its host-side range; its span: the device-side range
    host = {e.key: e for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    span = {e.key: e for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
    out["parts"] = {}
    for label in PARTS:
        us = _dev_us(host[label]) if label in host else 0.0
        out["parts"][label] = {
            "calls": host[label].count if label in host else 0,
            "device_s": us / 1e6, "share": us / kernel_us if kernel_us else 0.0,
            "device_span_s": _dev_us(span[label]) / 1e6 if label in span else 0.0}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=run.DEFAULT_CONFIG)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-slot", type=int, default=64)
    ap.add_argument("--max-prefills-per-step", type=int, default=1)
    ap.add_argument("--paged-kernel", action="store_true",
                    help="decode by walking the page tables (kernel #1); default: the "
                         "dense gather view through kernel #5")
    ap.add_argument("--chunk-pages", type=int, default=0,
                    help="prefill prompts longer than this many pages in chunks (0 = off)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="fork the pages of an already-seen prompt prefix (copy-on-write)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg, params = run.build(args.config, device=dev)
    ecfg = EngineConfig(
        max_slots=args.max_slots, page_size=args.page_size,
        pages_per_slot=args.pages_per_slot,
        max_prefills_per_step=args.max_prefills_per_step,
        use_paged_kernel=args.paged_kernel, prefill_chunk_pages=args.chunk_pages,
        prefix_sharing=args.prefix_sharing,
    )
    spec = WorkloadSpec(n_requests=16, vocab_size=cfg.vocab_size,
                        prompt_len=(64, 512), new_tokens=(16, 64), seed=0)
    run.serve(ServeEngine(cfg, params, ecfg, device=dev), build_workload(spec))  # warm-up
    out = profile_serve(ServeEngine(cfg, params, ecfg, device=dev), build_workload(spec))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
