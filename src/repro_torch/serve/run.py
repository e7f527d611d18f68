"""Single-replica serving entry point.

    PYTHONPATH=src python -m repro_torch.serve.run --config qwen3-0.6b [--device cuda]

Builds the model from a seed at the config's published widths (``--layers``
cuts the depth), generates a seeded workload, and serves it to completion
with one :class:`ServeEngine`.  Each step follows the JAX package's
``ReplicaSet.step`` for one replica without chaos or snapshots: arrivals,
then one chunk of every pending chunked prefill, then continuous admission
(same-bucket prompts grouped into one batched prefill, up to
``max_prefills_per_step``; a forked prefix or a chunked prompt starts its
own prefill), then one decode round.  Engine flags: ``--paged-kernel``
(the paged decode round; default the dense one), ``--chunk-pages N``
(chunked prefill), ``--prefix-sharing``; workload flags ``--shared-prefix
N`` and ``--prefix-groups N``.  Prints one JSON line with tokens/s,
TTFT/TPOT in steps and in ms, and the engine's counters.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.models.params import init_params
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.request import Request, RequestState, WorkloadSpec, build_workload

DEFAULT_CONFIG = "qwen3-0.6b"


@dataclass
class ServeResult:
    states: Dict[int, RequestState]
    n_steps: int
    # host wall at the start and at the end of every step; a step ends with
    # the host copy of its sampled tokens, so the device work is inside it
    step_start: List[float] = field(default_factory=list)
    step_end: List[float] = field(default_factory=list)
    # the engine's counters, drained at the end of the run
    accounting: Dict[str, int] = field(default_factory=dict)

    def streams(self) -> Dict[int, List[int]]:
        return {rid: list(rs.emitted) for rid, rs in self.states.items()}

    def summary(self) -> dict:
        done = [rs for rs in self.states.values() if rs.done]
        n_tok = sum(len(rs.emitted) for rs in self.states.values())
        wall = (self.step_end[-1] - self.step_start[0]) if self.step_end else 0.0
        ttft_steps = [rs.ttft_steps for rs in done]
        tpot_steps = [rs.tpot_steps for rs in done if rs.tpot_steps is not None]
        ttft_ms = [1e3 * (self.step_end[rs.first_token_step]
                          - self.step_start[rs.req.arrival_step]) for rs in done]
        tpot_ms = [1e3 * (self.step_end[rs.last_token_step]
                          - self.step_end[rs.first_token_step]) / (len(rs.emitted) - 1)
                   for rs in done if len(rs.emitted) > 1]

        def stats(xs):
            if not xs:
                return None
            return {"mean": float(np.mean(xs)), "p50": float(np.percentile(xs, 50)),
                    "p99": float(np.percentile(xs, 99))}

        return {
            "n_requests": len(self.states), "n_completed": len(done),
            "n_tokens": n_tok, "n_steps": self.n_steps, "wall_s": wall,
            "tok_per_s": n_tok / wall if wall > 0 else None,
            "ttft_steps": stats(ttft_steps), "tpot_steps": stats(tpot_steps),
            "ttft_ms": stats(ttft_ms), "tpot_ms": stats(tpot_ms),
        }


def check_workload_fits(workload: Sequence[Request], ecfg: EngineConfig) -> None:
    oversized = [req.rid for req in workload if req.total_len > ecfg.max_len]
    if oversized:
        raise ValueError(
            f"requests {oversized} need more than max_len={ecfg.max_len} "
            f"KV positions (page_size * pages_per_slot)"
        )


def admit(eng: ServeEngine, queue: List[RequestState], t: int):
    """Continuous admission, as ``ReplicaSet._admit_into``: bind requests
    from the queue head while the budget lasts and they fit; each run of
    equal-bucket prompts becomes one batched prefill, and a forked prefix
    or a chunked prompt flushes the batch and starts its own prefill.
    Returns ``[(state, first_token, completed)]``."""
    group: List = []
    out = []

    def flush():
        if group:
            toks = eng.prefill_bound([(s, rs) for s, rs, _ in group], t)
            out.extend((rs, tok, rs.done) for (_, rs, _), tok in zip(group, toks))
            group.clear()

    admitted = 0
    while queue and admitted < eng.ecfg.max_prefills_per_step:
        rs = queue[0]
        bound = eng.try_bind(rs, t)
        if bound is None:
            break
        queue.pop(0)
        slot, plan, is_complex = bound
        if is_complex:
            flush()
            tok = eng.start_prefill(slot, rs, plan, t)
            if tok is not None:  # else the first token comes from a later chunk
                out.append((rs, tok, rs.done))
        else:
            bucket = eng.prefill_bucket(rs)
            if group and group[0][2] != bucket:
                flush()
            group.append((slot, rs, bucket))
        admitted += 1
    flush()
    return out


def serve(eng: ServeEngine, workload: Sequence[Request], max_steps: int = 100_000
          ) -> ServeResult:
    """Serve ``workload`` to completion: each step releases the arrivals
    due, advances the pending chunked prefills, admits, and runs one decode
    round."""
    check_workload_fits(workload, eng.ecfg)
    wl = sorted(workload, key=lambda req: (req.arrival_step, req.rid))
    states: Dict[int, RequestState] = {}
    queue: List[RequestState] = []
    pending = {req.rid for req in workload}
    res = ServeResult(states, 0)
    t = nxt = 0
    while pending and t < max_steps:
        res.step_start.append(time.perf_counter())
        while nxt < len(wl) and wl[nxt].arrival_step <= t:
            rs = RequestState(wl[nxt])
            queue.append(rs)
            states[rs.rid] = rs
            nxt += 1
        events = eng.step_prefills(t)
        events += admit(eng, queue, t)
        events += eng.decode_round(t)
        for rs, _tok, done in events:
            if done:
                pending.discard(rs.rid)
        res.step_end.append(time.perf_counter())
        t += 1
    res.n_steps = t
    res.accounting = eng.drain_stats()
    return res


def build(config: str, *, device="cuda", layers: int = 0, dtype: str = "",
          use_reduced: bool = False, seed: int = 0):
    """(cfg, params) at the config's published widths, weights from
    ``seed``; ``layers`` > 0 cuts the depth."""
    dev = resolve_device(device)
    cfg = get_config(config)
    if use_reduced:
        cfg = reduced(cfg)
    over = {}
    if layers:
        over["n_layers"] = layers
    if dtype:
        over["dtype"] = dtype
    cfg: ModelConfig = dataclasses.replace(cfg, **over)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(cfg, gen, dev)


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The engine's flags, shared with :mod:`repro_torch.serve.profile`."""
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


def engine_config(args) -> EngineConfig:
    return EngineConfig(
        max_slots=args.max_slots, page_size=args.page_size,
        pages_per_slot=args.pages_per_slot,
        max_prefills_per_step=args.max_prefills_per_step,
        use_paged_kernel=args.paged_kernel, prefill_chunk_pages=args.chunk_pages,
        prefix_sharing=args.prefix_sharing,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0 = full)")
    ap.add_argument("--dtype", default="", help="override the config's dtype")
    ap.add_argument("--reduced", action="store_true", help="smoke-test widths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(64, 512))
    ap.add_argument("--new-tokens", type=int, nargs=2, default=(16, 64))
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="a common seeded prompt prefix of this many tokens")
    ap.add_argument("--prefix-groups", type=int, default=0,
                    help="draw each prompt's prefix from this many distinct ones")
    add_engine_args(ap)
    args = ap.parse_args(argv)

    cfg, params = build(args.config, device=args.device, layers=args.layers,
                        dtype=args.dtype, use_reduced=args.reduced, seed=args.seed)
    spec = WorkloadSpec(
        n_requests=args.n_requests, vocab_size=cfg.vocab_size, seed=args.seed,
        prompt_len=tuple(args.prompt_len), new_tokens=tuple(args.new_tokens),
        shared_prefix=args.shared_prefix, n_prefix_groups=args.prefix_groups,
    )
    eng = ServeEngine(cfg, params, engine_config(args), device=args.device)
    res = serve(eng, build_workload(spec))
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "device": str(eng.device), "decode": "paged" if args.paged_kernel else "dense",
           **res.summary(), **res.accounting, "decode_wall_s": eng.decode_wall_s,
           "prefill_calls": eng.prefill_calls, "chunk_calls": eng.chunk_calls,
           "prefill_wall_s": eng.prefill_wall_s}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
