"""The serve CLI: run, record and replay deterministic serve traces
(counterpart of ``repro.serve.run``).

Record a trace on the card (``--device cpu`` on a machine without one):

    PYTHONPATH=src python -m repro_torch.serve.run --record trace.jsonl \
        --n-replicas 3 --chaos pod --fail-every 12 --heal-steps 6

Replay it bit-exactly (non-zero exit on drift):

    PYTHONPATH=src python -m repro_torch.serve.run --replay trace.jsonl \
        --replay-record /tmp/replayed.jsonl

The flags and defaults are the JAX CLI's (the reduced config unless
``--full``), plus ``--device``, without ``--kernel-interpret``.  Replay
rebuilds everything from the trace header (model config, engine geometry,
workload, chaos injectors, seeds), re-simulates the whole run through
:class:`~repro_torch.serve.replicas.ReplicaSet`, and checks the event
stream, token streams, accounting and policy decisions against the
recording.  Traces load in either package.  Weights come from the header's
seed through the port's own initializer, so the token values of a trace
recorded by the JAX package differ here; everything else replays.  A run
prints one JSON line: tokens/s, TTFT/TPOT in steps and in ms, the router's
accounting and the decode and snapshot wall times.

Library functions: :func:`build` (a config's params from a seed) and
:func:`serve` (one engine, no chaos), which ``chip_smoke.py``'s serve
phases and :mod:`repro_torch.serve.profile` drive.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from dataclasses import asdict
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.ft.events import FAIL, TRAFFIC_SPIKE, FailureEvent
from repro_torch.ft.injectors import (
    Injector,
    PodOutageInjector,
    ScheduledInjector,
    TrafficSpikeInjector,
)
from repro_torch.models.params import init_params
from repro_torch.serve.engine import EngineConfig, ServeEngine, resolve_kernel_impl
from repro_torch.serve.replicas import ReplicaSet, ServeResult, check_workload_fits
from repro_torch.serve.request import Request, RequestState, WorkloadSpec, build_workload
from repro_torch.serve.trace import (
    ServeTraceHeader,
    ServeTraceRecorder,
    load_serve_trace,
    verify_serve_replay,
)

__all__ = ["ServeResult", "check_workload_fits", "build", "serve", "main"]

DEFAULT_CONFIG = "qwen3-0.6b"

_log = logging.getLogger("repro_torch.serve")


# ---------------------------------------------------------------------------
# library: one engine, no chaos
# ---------------------------------------------------------------------------


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
    """Serve ``workload`` to completion on one engine: each step releases
    the arrivals due, advances the pending chunked prefills, admits, and
    runs one decode round (``ReplicaSet.step`` for one replica without
    chaos or snapshots)."""
    check_workload_fits(workload, eng.ecfg)
    wl = sorted(workload, key=lambda req: (req.arrival_step, req.rid))
    queue: List[RequestState] = []
    pending = {req.rid for req in workload}
    res = ServeResult(states={}, accounting={}, n_steps=0)
    t = nxt = 0
    while pending and t < max_steps:
        res.step_start.append(time.perf_counter())
        while nxt < len(wl) and wl[nxt].arrival_step <= t:
            rs = RequestState(wl[nxt])
            queue.append(rs)
            res.states[rs.rid] = rs
            res.arrive_step[rs.rid] = t
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
    res.decode_wall_s = eng.decode_wall_s
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


# ---------------------------------------------------------------------------
# the reference's CLI: a ReplicaSet from a trace header
# ---------------------------------------------------------------------------


def injectors_from_spec(spec: dict) -> List[Injector]:
    """Chaos injectors from the JSON-able spec pinned in the trace header."""
    kind = spec.get("kind", "none")
    if kind == "none":
        return []
    if kind == "pod":
        return [PodOutageInjector(
            fail_interval_s=float(spec["fail_every_steps"]),
            heal_time_s=float(spec["heal_steps"]),
            ranks_per_pod=int(spec.get("ranks_per_pod", 1)),
            transfer_steps=int(spec.get("transfer_steps", 1)),
        )]
    if kind == "spike":
        return [TrafficSpikeInjector(
            mean_interval_s=float(spec["mean_interval_steps"]),
            duration_s=float(spec["duration_steps"]),
            magnitude=float(spec.get("magnitude", 4.0)),
        )]
    if kind == "scripted":
        events = [
            FailureEvent(step=int(s), kind=FAIL, device=(int(r), 0),
                         duration_steps=int(d), source="scripted")
            for s, r, d in spec.get("kills", ())
        ]
        events += [
            FailureEvent(step=int(s), kind=TRAFFIC_SPIKE, device=None,
                         duration_steps=int(d), magnitude=float(m),
                         source="scripted")
            for s, d, m in spec.get("spikes", ())
        ]
        return [ScheduledInjector(events)]
    if kind == "multi":  # composed chaos, e.g. pod outages + spikes
        out: List[Injector] = []
        for sub in spec["specs"]:
            out.extend(injectors_from_spec(sub))
        return out
    raise ValueError(f"unknown chaos spec kind {kind!r}")


def header_config(header: ServeTraceHeader) -> ModelConfig:
    cfg = get_config(header.config)
    return reduced(cfg, dtype=header.dtype) if header.reduced else cfg


def build_replica_set(header: ServeTraceHeader, recorder=None, *, device="cuda",
                      params=None) -> Tuple[ReplicaSet, List[Request]]:
    """(ReplicaSet, workload) from a (possibly freshly built) header.
    ``params`` (the header's config's, on ``device``) skips the seeded
    initialization, for callers that run one model many times."""
    dev = resolve_device(device)
    cfg = header_config(header)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(header.seed), dev)
    ecfg = EngineConfig(**header.engine)
    spec = WorkloadSpec.from_json(header.workload)
    if spec.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"workload vocab {spec.vocab_size} != model vocab {cfg.vocab_size}"
        )
    workload = build_workload(spec)
    check_workload_fits(workload, ecfg)  # before any trace header is written
    rs = ReplicaSet(
        cfg, params, ecfg,
        n_replicas=header.n_replicas,
        device=dev,
        ranks_per_pod=header.ranks_per_pod,
        injectors=injectors_from_spec(header.chaos),
        chaos_seed=header.seed,
        snapshots=header.snapshots,
        snapshot_cadence=header.snapshot_cadence,
        layout_seed=header.layout_seed,
        recorder=recorder,
        policy=header.policy,
    )
    return rs, workload


def run_from_header(header: ServeTraceHeader, record_path: Optional[str] = None,
                    rset_hook=None, *, device="cuda", params=None
                    ) -> Tuple[ServeResult, ReplicaSet]:
    """Run one serve workload; returns (result, the ReplicaSet that ran it).

    ``rset_hook`` is called with the ReplicaSet before the run starts (the
    CLI arms the crash-flush hook with it and reaches the incident manager
    after replays)."""
    recorder = ServeTraceRecorder(record_path) if record_path else None
    rset, workload = build_replica_set(header, recorder=recorder, device=device,
                                       params=params)
    if rset_hook is not None:
        rset_hook(rset)
    # the decode route this run takes (informational: a replay on another
    # route must still be bit-exact)
    header.kernel_impl = resolve_kernel_impl(EngineConfig(**header.engine), rset.device)
    if recorder is not None:  # header only once the setup validated
        recorder.write_header(header)
    result = rset.run(workload)
    if recorder is not None:
        recorder.close(result.n_steps, result.streams_sha256(), result.accounting)
    return result, rset


def replay_serve_trace(path, replay_record: Optional[str] = None,
                       paged_kernel: bool = False, rset_hook=None, *, device="cuda",
                       params=None) -> List[str]:
    """Re-simulate ``path`` and return mismatch descriptions (empty =
    exact).  ``paged_kernel=True`` replays on the paged round whatever the
    trace recorded: swapping the decode data path changes no event or
    token."""
    trace = load_serve_trace(path)
    if paged_kernel:
        trace.header.engine = dict(trace.header.engine, use_paged_kernel=True)
    result, rset = run_from_header(trace.header, record_path=replay_record,
                                   rset_hook=rset_hook, device=device, params=params)
    return verify_serve_replay(
        trace, rset.events, accounting=result.accounting,
        streams_sha256=result.streams_sha256(),
        decisions=(rset.policy.decisions if rset.policy is not None else None),
    )


def parse_priority_classes(s: str) -> tuple:
    """``"prio:weight:deadline,..."`` -> WorkloadSpec.priority_classes."""
    if not s:
        return ()
    out = []
    for part in s.split(","):
        p, w, d = part.split(":")
        out.append((int(p), float(w), int(d)))
    return tuple(out)


def chaos_spec_from_args(args) -> dict:
    specs: List[dict] = []
    if args.chaos in ("pod", "pod+spike"):
        specs.append({
            "kind": "pod", "fail_every_steps": args.fail_every,
            "heal_steps": args.heal_steps,
            "ranks_per_pod": args.ranks_per_pod,
            "transfer_steps": args.transfer_steps,
        })
    if args.chaos in ("spike", "pod+spike"):
        specs.append({
            "kind": "spike", "mean_interval_steps": args.spike_every,
            "duration_steps": args.spike_duration,
            "magnitude": args.spike_magnitude,
        })
    if not specs:
        return {"kind": "none"}
    if len(specs) == 1:
        return specs[0]
    return {"kind": "multi", "specs": specs}


def header_from_args(args) -> ServeTraceHeader:
    chaos = chaos_spec_from_args(args)
    cfg = get_config(args.config)
    vocab = reduced(cfg).vocab_size if args.reduced else cfg.vocab_size
    spec = WorkloadSpec(
        n_requests=args.requests, vocab_size=vocab, seed=args.seed,
        mean_interarrival_steps=args.mean_interarrival,
        prompt_len=(args.prompt_min, args.prompt_max),
        new_tokens=(args.gen_min, args.gen_max),
        shared_prefix=args.shared_prefix,
        arrival=args.arrival,
        burst_factor=args.burst_factor,
        burst_period=args.burst_period,
        burst_duty=args.burst_duty,
        length_dist=args.length_dist,
        n_prefix_groups=args.prefix_groups,
        priority_classes=parse_priority_classes(args.priority_classes),
    )
    ecfg = EngineConfig(
        max_slots=args.slots, page_size=args.page_size,
        pages_per_slot=args.pages_per_slot,
        n_pages=args.n_pages,
        admission=args.admission,
        max_prefills_per_step=args.max_prefills,
        use_paged_kernel=args.paged_kernel,
        kv_dtype=args.kv_dtype,
        prefill_chunk_pages=args.chunk_pages,
        prefix_sharing=args.prefix_sharing or args.shared_prefix > 0,
        preemption=args.preempt,
    )
    return ServeTraceHeader(
        config=args.config, reduced=args.reduced, dtype="float32",
        seed=args.seed, n_replicas=args.n_replicas,
        ranks_per_pod=args.ranks_per_pod,
        snapshots=not args.no_snapshots,
        snapshot_cadence=args.snapshot_cadence,
        layout_seed=args.seed,
        engine=asdict(ecfg), workload=spec.to_json(), chaos=chaos,
        policy=args.ft_policy or "",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="serve the full-size config (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-replicas", type=int, default=3)
    ap.add_argument("--ranks-per-pod", type=int, default=1)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pages-per-slot", type=int, default=8)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--mean-interarrival", type=float, default=1.5)
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=20)
    ap.add_argument("--gen-min", type=int, default=4)
    ap.add_argument("--gen-max", type=int, default=24)
    ap.add_argument("--chaos", default="pod",
                    choices=["none", "pod", "spike", "pod+spike"])
    ap.add_argument("--fail-every", type=float, default=12.0,
                    help="mean steps between pod outages")
    ap.add_argument("--heal-steps", type=float, default=6.0)
    ap.add_argument("--transfer-steps", type=int, default=1)
    ap.add_argument("--spike-every", type=float, default=48.0,
                    help="mean steps between traffic spikes")
    ap.add_argument("--spike-duration", type=float, default=12.0)
    ap.add_argument("--spike-magnitude", type=float, default=4.0,
                    help="arrival-rate multiplier while a spike is active")
    ap.add_argument("--snapshot-cadence", type=int, default=2)
    ap.add_argument("--no-snapshots", action="store_true")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="page-table-walking decode round (on replay: override the "
                         "recorded engine config)")
    ap.add_argument("--kv-dtype", default="", choices=["", "int8"],
                    help="paged KV pool dtype: int8 quantizes pages with per-page scales "
                         "(needs --paged-kernel)")
    ap.add_argument("--max-prefills", type=int, default=1,
                    help="batched-prefill admission budget per step")
    ap.add_argument("--chunk-pages", type=int, default=0,
                    help="chunk prompts longer than this many pages")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="COW page sharing for common prompt prefixes")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared prompt-prefix tokens in the workload "
                         "(implies --prefix-sharing)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="physical KV pages (0 = full reserve)")
    ap.add_argument("--admission", default="continuous",
                    choices=["continuous", "lockstep", "priority"])
    ap.add_argument("--preempt", action="store_true",
                    help="evict-and-replay preemption (needs --admission priority)")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "diurnal"])
    ap.add_argument("--burst-factor", type=float, default=4.0)
    ap.add_argument("--burst-period", type=int, default=64)
    ap.add_argument("--burst-duty", type=float, default=0.25)
    ap.add_argument("--length-dist", default="uniform",
                    choices=["uniform", "longtail"])
    ap.add_argument("--prefix-groups", type=int, default=0,
                    help="distinct system-prompt populations (needs --shared-prefix)")
    ap.add_argument("--ft-policy", default="", metavar="SPEC",
                    help="recovery-policy engine: 'adaptive' scores every applicable "
                         "restore path with the online cost model and picks the "
                         "cheapest; 'fixed:<path>' pins one (migrate_snapshot | "
                         "migrate_replay). Empty = the static snapshot-first dispatch.")
    ap.add_argument("--priority-classes", default="",
                    help="prio:weight:deadline[,...] request classes, e.g. "
                         "'2:0.2:0,1:0.3:48,0:0.5:32'")
    ap.add_argument("--record", default=None, metavar="PATH")
    ap.add_argument("--replay", default=None, metavar="PATH")
    ap.add_argument("--replay-record", default=None, metavar="PATH",
                    help="also record the replayed run (diffable on drift)")
    ap.add_argument("--obs-out", default=None, metavar="PATH",
                    help="write run telemetry (metrics + span timeline) as JSONL to "
                         "PATH, the Prometheus exposition to PATH.prom, and render the "
                         "run report")
    ap.add_argument("--incidents-out", default=None, metavar="PATH",
                    help="write the incident log (flight-recorder windows + attributed "
                         "failover costs) as JSONL to PATH; render with "
                         "'python -m repro_torch.obs incidents PATH'")
    args = ap.parse_args(argv)
    obs.logging_setup()
    device = resolve_device(args.device)
    holder: dict = {"rset": None}
    try:
        return _main(args, ap, device, holder)
    finally:
        # the crash-flush proxy class below lives in a reference cycle, so
        # without this an in-process caller would hold the run's engines
        # (their page pools) until the next garbage collection
        holder["rset"] = None


def _main(args, ap, device, holder: dict) -> int:
    if args.ft_policy:
        from repro_torch.ft.policy import parse_policy
        try:
            parse_policy(args.ft_policy)
        except ValueError as e:
            ap.error(str(e))

    run_meta = {
        "run": "serve", "config": args.config,
        "chaos": args.chaos, "admission": args.admission,
        "ft_policy": args.ft_policy or None,
    }

    class _MgrProxy:
        """Late-bound incident manager for the crash-flush hook (the
        ReplicaSet does not exist yet when the hook is armed)."""

        @property
        def mgr(self):
            rs = holder["rset"]
            return rs.incidents.mgr if rs is not None else None

    def grab_rset(rs) -> None:
        holder["rset"] = rs

    disarm = None
    if args.obs_out or args.incidents_out:
        disarm = obs.install_crash_flush(
            obs_path=args.obs_out, incidents_path=args.incidents_out,
            incidents=_MgrProxy(), meta=run_meta,
        )

    def dump_obs(mode: str) -> None:
        if disarm is not None:
            disarm()
        if args.obs_out:
            path = obs.dump(args.obs_out, meta={**run_meta, "mode": mode})
            _log.info("obs telemetry written to %s (+ .prom)", path)
            sys.stdout.write(obs.render_report_file(path))
        if args.incidents_out and holder["rset"] is not None:
            mgr = holder["rset"].incidents.mgr
            path = obs.write_incident_log(
                args.incidents_out, mgr, meta={**run_meta, "mode": mode}
            )
            _log.info("incident log written to %s (%d incidents)", path,
                      len(mgr.incidents))

    if args.replay:
        problems = replay_serve_trace(
            args.replay, args.replay_record, paged_kernel=args.paged_kernel,
            rset_hook=grab_rset, device=device,
        )
        dump_obs("replay")
        if problems:
            _log.error("serve replay DIVERGED from %s:", args.replay)
            for p in problems:
                _log.error("  %s", p)
            return 1
        kernel = " (paged kernel)" if args.paged_kernel else ""
        _log.info("serve replay of %s is bit-exact%s", args.replay, kernel)
        return 0

    header = header_from_args(args)
    result, rset = run_from_header(header, record_path=args.record,
                                   rset_hook=grab_rset, device=device)
    acct = result.accounting
    done = sum(1 for rs in result.states.values() if rs.done)
    _log.info(
        "served %d/%d requests, %d tokens in %d steps; kills=%d "
        "migrations=%d (snapshot=%d replay=%d, replayed_tokens=%d); "
        "spikes=%d shed=%d preemptions=%d",
        done, acct["n_requests"], acct["n_tokens"], result.n_steps,
        acct["n_kills"], acct["n_migrations"], acct["n_restore_snapshot"],
        acct["n_restore_replay"], acct["replayed_tokens"], acct["n_spikes"],
        acct["n_shed"], acct["n_preemptions"],
    )
    print(json.dumps({
        "config": rset.cfg.name, "n_layers": rset.cfg.n_layers, "dtype": rset.cfg.dtype,
        "device": str(device), "decode": header.kernel_impl or "dense",
        **result.summary(), **acct, "decode_wall_s": result.decode_wall_s,
        "snapshot_wall_s": result.snapshot_wall_s,
    }), flush=True)
    dump_obs("run")
    if args.record:
        _log.info("trace recorded to %s", args.record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
