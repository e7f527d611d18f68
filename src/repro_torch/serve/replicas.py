"""Replica set: chaos-driven kills, KV-snapshot replication, migration
(counterpart of ``repro.serve.replicas``).

Replicas map onto DP ranks of an ``(n_replicas, 1)`` chaos grid, so the
existing ``ft`` injectors drive serving failures unchanged —
:class:`~repro_torch.ft.injectors.PodOutageInjector` kills whole pods of replicas,
``ScheduledInjector`` scripts deterministic kills for tests and golden
traces.  A replica's death is a ``fail`` event on its device; it comes back
at the engine's derived ``rejoin`` (heal + transfer window), with a fresh
empty engine.

KV-page snapshots follow the ``statexfer`` pattern: every ``cadence`` steps
each alive replica pushes, for every in-flight request, a host copy of the
pages covering its ``cur_len`` to a *peer* replica chosen by
``ring_peers`` over the ``pod_domains`` topology — so one pod outage never
takes a request's slot *and* the replica holding its snapshot.  When a
replica dies, its in-flight requests re-queue at the front and are
re-admitted on surviving replicas: from the peer snapshot (plus
teacher-forced replay of tokens emitted after it) when one survives, else
by full deterministic re-prefill.  Either way the continued stream is
bit-identical to the unkilled run (see ``serve/engine.py``'s determinism
contract).

Overload is first-class chaos: a ``TrafficSpikeInjector`` event multiplies
the arrival clock (``run`` releases requests whose nominal arrival step the
accelerated clock has passed), so a surge compresses the same workload into
fewer engine steps — deterministically, so overload golden traces replay
bit-exactly.  Under ``admission="priority"`` the router queue is kept
stably sorted by priority class, never-started requests whose deadline
already expired are shed at the head, and with ``preemption=True`` a
request that cannot fit may evict strictly lower-priority victims
(youngest first); victims re-queue at the front and re-admit through the
same restore paths as failover migrants, so their streams stay
token-identical to an unpreempted run.

On one card every replica's engine holds the same params tree and its own
page pool.  A snapshot copies a request's pages to the host with one
transfer per leaf; its wall time sums into ``ServeResult.snapshot_wall_s``
(a side channel, like ``decode_wall_s``: footers pin integers only).
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.ft.events import FAIL, RANK_REJOIN, TRAFFIC_SPIKE
from repro_torch.ft.failures import ChaosEngine
from repro_torch.ft.injectors import Injector
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.trace import ServeEvent
from repro_torch.statexfer.replication import pod_domains, ring_peers

Tree = Any


@dataclass
class KVSnapshot:
    """One in-flight request's KV pages as held by a peer replica."""

    rid: int
    holder: int
    step: int
    n_emitted: int
    cur_len: int
    pages: Tree  # host tensors, (np, n_pages_covering_cur_len, ps, KV, hd)
    nbytes: int


class KVSnapshotRegistry:
    """Who holds whose in-flight KV state (request-keyed ReplicaStore)."""

    def __init__(self):
        self._snaps: Dict[int, KVSnapshot] = {}
        self.n_pushes = 0
        self.pushed_bytes = 0

    def push(self, snap: KVSnapshot) -> None:
        self._snaps[snap.rid] = snap
        self.n_pushes += 1
        self.pushed_bytes += snap.nbytes

    def get(self, rid: int) -> Optional[KVSnapshot]:
        return self._snaps.get(rid)

    def drop(self, rid: int) -> None:
        self._snaps.pop(rid, None)

    def lose_holder(self, holder: int) -> List[int]:
        """The holder's domain died: its held snapshots are gone.  Returns
        the owning request ids (they will fall back to re-prefill)."""
        lost = sorted(
            r for r, s in self._snaps.items() if s.holder == holder
        )
        for r in lost:
            del self._snaps[r]
        return lost

    def __len__(self) -> int:
        return len(self._snaps)


def check_workload_fits(workload: Sequence[Request],
                        ecfg: EngineConfig) -> None:
    """Reject requests that can NEVER fit a slot — admitting one would
    otherwise crash (or stall the queue head) mid-run, at a data-dependent
    step, possibly leaving a footerless trace."""
    oversized = [
        req.rid for req in workload if req.total_len > ecfg.max_len
    ]
    if oversized:
        raise ValueError(
            f"requests {oversized} need more than max_len={ecfg.max_len} "
            f"KV positions (page_size * pages_per_slot); enlarge the "
            f"engine or bound the workload"
        )


@dataclass
class ServeResult:
    states: Dict[int, RequestState]
    accounting: Dict[str, int]
    n_steps: int
    # synchronized wall spent inside decode rounds, summed over engines —
    # kept out of ``accounting`` (trace footers pin those ints bit-exactly)
    decode_wall_s: float = 0.0
    # wall spent copying snapshots to the host, summed over pushes
    snapshot_wall_s: float = 0.0
    # host wall at the start and at the end of every step; a step ends with
    # the host copy of its sampled tokens, so its device work is inside it
    step_start: List[float] = field(default_factory=list)
    step_end: List[float] = field(default_factory=list)
    # the step each request reached the router (a spike releases early)
    arrive_step: Dict[int, int] = field(default_factory=dict)

    @property
    def step_wall(self) -> List[float]:
        return [e - s for s, e in zip(self.step_start, self.step_end)]

    def streams(self) -> Dict[int, List[int]]:
        return {rid: list(rs.emitted) for rid, rs in self.states.items()}

    def streams_sha256(self) -> str:
        payload = json.dumps(
            sorted((rid, s) for rid, s in self.streams().items())
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def summary(self) -> dict:
        """Tokens/s over the run's wall, TTFT and TPOT in steps (the
        requests' own step marks) and in ms (step wall clocks from the step
        a request reached the router), over the completed requests."""
        done = [rs for rs in self.states.values() if rs.done]
        n_tok = sum(len(rs.emitted) for rs in self.states.values())
        wall = (self.step_end[-1] - self.step_start[0]) if self.step_end else 0.0
        ttft_ms = [1e3 * (self.step_end[rs.first_token_step]
                          - self.step_start[self.arrive_step[rs.rid]]) for rs in done]
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
            "ttft_steps": stats([rs.ttft_steps for rs in done]),
            "tpot_steps": stats([rs.tpot_steps for rs in done if rs.tpot_steps is not None]),
            "ttft_ms": stats(ttft_ms), "tpot_ms": stats(tpot_ms),
        }


class ReplicaSet:
    """N serving replicas + router + chaos + snapshot replication."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Tree,
        ecfg: EngineConfig,
        n_replicas: int = 2,
        *,
        device="cuda",
        ranks_per_pod: int = 1,
        injectors: Sequence[Injector] = (),
        chaos_seed: int = 0,
        snapshots: bool = True,
        snapshot_cadence: int = 1,
        layout_seed: Optional[int] = None,
        recorder=None,
        policy: str = "",
    ):
        self.cfg, self.params = cfg, params
        self.ecfg = ecfg
        self.device = device
        self.n_replicas = n_replicas
        self.pod_of = pod_domains(n_replicas, ranks_per_pod)
        self.snapshots = snapshots
        self.snapshot_cadence = max(int(snapshot_cadence), 1)
        self.layout_seed = layout_seed
        # membership bookkeeping always on: replica revival rides the
        # derived rejoin events, whatever the injector mix
        self.chaos = ChaosEngine(
            n_replicas, 1, 1.0, injectors=list(injectors), seed=chaos_seed,
            elastic=True,
        )
        self.engines: Dict[int, Optional[ServeEngine]] = {
            r: self._fresh_engine(r) for r in range(n_replicas)
        }
        self.alive = set(range(n_replicas))
        self.registry = KVSnapshotRegistry()
        self.queue: List[RequestState] = []
        self.requests: Dict[int, RequestState] = {}
        self.events: List[ServeEvent] = []
        self.recorder = recorder
        # traffic-spike state: the multiplier the *previous* step's chaos
        # left active, applied to the arrival clock before the next step
        self._arrival_mult = 1.0
        self._decode_wall = 0.0
        self._snapshot_wall = 0.0
        # the acct key set is the catalog's router keys + everything each
        # engine's drain_stats() hands back — one declaration, shared with
        # the engine reset, the exporters, and the docs (serve-trace
        # footers pin exactly these keys)
        self.acct: Dict[str, int] = {k: 0 for k in obs.ROUTER_ACCT_KEYS}
        # router-owned telemetry: the router-only counters mirror onto
        # serve.router.* at run() end (engine-derived keys are exported by
        # the engines themselves as serve.engine.* / serve.alloc.*), the
        # latency distributions feed the TTFT/TPOT histograms, and the
        # decode wall sum lands on serve.decode.wall_s
        self._obs_router = {
            k: obs.counter(f"serve.router.{k}")
            for k in obs.catalog.ROUTER_ONLY_KEYS
        }
        self._obs_ttft = obs.histogram("serve.ttft_steps")
        self._obs_tpot = obs.histogram("serve.tpot_steps")
        self._obs_decode_wall = obs.counter("serve.decode.wall_s")
        self._obs_mirrored = {k: 0 for k in self._obs_router}
        # incident pipeline (pure side channel): every failover/overload
        # acct increment is mirrored onto exactly one incident
        self.incidents = obs.ServeIncidents()
        # adaptive restore-path selection for migrants (repro_torch.ft.policy);
        # empty spec -> the legacy snapshot-first dispatch
        from repro_torch.ft.policy import make_policy

        self.policy_spec = policy or ""
        self.policy = make_policy(policy or None,
                                  cost=self.incidents.mgr.cost)

    def _fresh_engine(self, r: int) -> ServeEngine:
        rng = (
            np.random.default_rng([self.layout_seed, r])
            if self.layout_seed is not None else None
        )
        return ServeEngine(self.cfg, self.params, self.ecfg, device=self.device,
                           alloc_rng=rng)

    # ------------------------------------------------------------------
    def _emit(self, ev: ServeEvent, out: List[ServeEvent]) -> None:
        out.append(ev)
        self.events.append(ev)

    def step(self, t: int, arrivals: Sequence[Request] = ()) -> List[ServeEvent]:
        out: List[ServeEvent] = []
        # 1. arrivals
        for req in arrivals:
            rs = RequestState(req)
            self.queue.append(rs)
            self.requests[req.rid] = rs
            self.acct["n_requests"] += 1
            self._emit(ServeEvent(t, "arrive", req=req.rid), out)

        # 2. chaos: kills, revivals, and traffic spikes (the spike's rate
        # multiplier reaches `run`'s arrival clock from the *next* step on)
        outcome = self.chaos.step(t)
        self._arrival_mult = outcome.arrival_mult
        for ev in outcome.events:
            if ev.kind == FAIL and ev.device is not None:
                r = ev.device[0]
                if r in self.alive:
                    self._kill(r, t, out)
            elif ev.kind == RANK_REJOIN and ev.rank is not None:
                if ev.rank not in self.alive:
                    self.engines[ev.rank] = self._fresh_engine(ev.rank)
                    self.alive.add(ev.rank)
                    self.acct["n_revives"] += 1
                    self._emit(ServeEvent(t, "revive", replica=ev.rank), out)
            elif ev.kind == TRAFFIC_SPIKE:
                self.acct["n_spikes"] += 1
                self._emit(ServeEvent(
                    t, "spike", magnitude=ev.magnitude,
                    duration=max(ev.duration_steps, 1),
                ), out)

        # 2.5 chunked prefills: each pending prompt advances one page-aligned
        # chunk, interleaved with the decode rounds below (finished prompts
        # emit their first token here)
        for r in sorted(self.alive):
            for rs, tok, done in self.engines[r].step_prefills(t):
                self.acct["n_tokens"] += 1
                self._emit(
                    ServeEvent(t, "token", req=rs.rid, replica=r, token=tok),
                    out,
                )
                if done:
                    self.registry.drop(rs.rid)
                    self._emit(ServeEvent(t, "complete", req=rs.rid,
                                          replica=r), out)

        # 3. admissions (fresh requests and migrants, least-loaded first).
        # Priority admission keeps the queue stably sorted each step: FIFO
        # within a class, higher classes first; migrants and preempted
        # victims re-queued at the front stay at the front of their class.
        if self.ecfg.admission == "priority":
            self.queue.sort(key=lambda rs: -rs.req.priority)
        for r in sorted(self.alive,
                        key=lambda r: (self.engines[r].n_active, r)):
            self._admit_into(r, t, out)

        # 4. decode rounds
        for r in sorted(self.alive):
            for rs, tok, done in self.engines[r].decode_round(t):
                self.acct["n_tokens"] += 1
                self._emit(
                    ServeEvent(t, "token", req=rs.rid, replica=r, token=tok),
                    out,
                )
                if done:
                    self.registry.drop(rs.rid)
                    self._emit(ServeEvent(t, "complete", req=rs.rid,
                                          replica=r), out)

        # 5. KV-snapshot replication (covers this step's tokens)
        if self.snapshots and t % self.snapshot_cadence == 0:
            peers = ring_peers(sorted(self.alive), self.pod_of)
            for r in sorted(self.alive):
                holder = peers.get(r)
                if holder is None:
                    continue
                eng = self.engines[r]
                for slot, rs in eng.live_states():
                    t0 = time.perf_counter()
                    pages, n_emitted, cur_len, nbytes = eng.snapshot_slot(slot)
                    self._snapshot_wall += time.perf_counter() - t0
                    self.registry.push(KVSnapshot(
                        rid=rs.rid, holder=holder, step=t,
                        n_emitted=n_emitted, cur_len=cur_len,
                        pages=pages, nbytes=nbytes,
                    ))
                    self.acct["n_snapshots"] += 1
                    self.acct["snapshot_bytes"] += nbytes

        self.incidents.on_step(t, out)
        if self.recorder is not None:
            self.recorder.record(out)
            if self.policy is not None:
                for dec in self.policy.drain():
                    self.recorder.record_decision(dec)
        return out

    def _kill(self, r: int, t: int, out: List[ServeEvent]) -> None:
        # the dead replica's pages are gone, and so is every snapshot it
        # *held* for peers; snapshots of its own requests held elsewhere
        # survive and drive the snapshot-path migration
        with obs.span("router.failover"):
            self.registry.lose_holder(r)
            self._harvest(self.engines[r])
            migrants = self.engines[r].kill()
            self.engines[r] = None
            self.alive.discard(r)
        self.incidents.note_kill(r, [rs.rid for rs in migrants])
        self.acct["n_kills"] += 1
        self._emit(ServeEvent(t, "kill", replica=r,
                              n_inflight=len(migrants)), out)
        # migrants wait at the front of the queue, in rid order
        self.queue[:0] = migrants

    def _admit_into(self, r: int, t: int, out: List[ServeEvent]) -> None:
        eng = self.engines[r]
        if self.ecfg.admission == "lockstep":
            # baseline: refill only once the whole batch has drained
            if eng.n_active > 0:
                return
            budget = self.ecfg.max_slots
        else:
            budget = self.ecfg.max_prefills_per_step

        group: List = []  # bound same-bucket full prefills, flushed as one

        def emit_prefilled(rs, tok) -> None:
            self._emit(ServeEvent(t, "admit", req=rs.rid, replica=r), out)
            if tok is None:  # chunked: the first token arrives later
                return
            self.acct["n_tokens"] += 1
            self._emit(ServeEvent(t, "token", req=rs.rid, replica=r,
                                  token=tok), out)
            if rs.done:  # max_new_tokens == 1: done at the prefill
                self.registry.drop(rs.rid)
                self._emit(ServeEvent(t, "complete", req=rs.rid,
                                      replica=r), out)

        def flush() -> None:
            if not group:
                return
            toks = eng.prefill_bound([(s, rs) for s, rs, _ in group], t)
            for (_, rs, _), tok in zip(group, toks):
                emit_prefilled(rs, tok)
            group.clear()

        def preempt_for(rs) -> bool:
            """Evict strictly-lower-priority victims so ``rs`` fits.  The
            victims re-queue at the front (right behind the head) and
            re-admit later through the restore paths — token-identical."""
            if not self.ecfg.preemption:
                return False
            victims = eng.plan_preemption(rs, t)
            if victims is None:
                return False
            flush()
            evicted = [eng.preempt(v, t) for v in victims]
            for v_rs in evicted:
                self.incidents.note_preempt(v_rs.rid, len(v_rs.emitted))
                self.acct["preempted_tokens"] += len(v_rs.emitted)
                self._emit(ServeEvent(t, "preempt", req=v_rs.rid,
                                      replica=r), out)
            self.queue[1:1] = evicted
            return True

        admitted = 0
        while self.queue and admitted < budget:
            rs = self.queue[0]
            if (
                self.ecfg.admission == "priority"
                and not rs.emitted and rs.req.deadline_steps > 0
                and t > rs.req.arrival_step + rs.req.deadline_steps
            ):
                # load shedding: a never-started request past its deadline
                # can no longer be good — drop it instead of burning pages
                self.queue.pop(0)
                rs.shed = True
                self.acct["n_shed"] += 1
                self._emit(ServeEvent(t, "shed", req=rs.rid), out)
                continue  # shedding consumes no admission budget
            if rs.emitted:  # migrated / re-queued: restore, don't restart
                flush()
                snap = self.registry.get(rs.rid)
                dec = None
                if self.policy is not None:
                    # decide the restore path up front; forcing the replay
                    # path just drops the snapshot from the admission call
                    dec = self.policy.decide(
                        self.incidents.owner_kind(rs.rid),
                        f"req:{rs.rid}", t,
                        valid={"migrate_snapshot": snap is not None},
                    )
                    if dec["chosen"] == "migrate_replay":
                        snap = None
                with obs.span("router.restore"):
                    res = eng.try_admit_restored(rs, snap, t)
                    if res is None and preempt_for(rs):
                        res = eng.try_admit_restored(rs, snap, t)
                if res is None:
                    break  # the undone decision is discarded (re-derived
                    # identically when the retry actually admits)
                self.queue.pop(0)
                if dec is not None:
                    self.policy.commit(dec)
                    self.incidents.note_decision(rs.rid, dec)
                path, replayed = res
                key = "n_restore_snapshot" if path == "snapshot" else \
                    "n_restore_replay"
                self.acct[key] += 1
                self.acct["n_migrations"] += 1
                self.acct["replayed_tokens"] += replayed
                if snap is not None:
                    self.acct["restored_bytes"] += snap.nbytes
                self._emit(ServeEvent(
                    t, "migrate", req=rs.rid, replica=r, path=path,
                    replayed=replayed,
                    nbytes=snap.nbytes if snap is not None else 0,
                ), out)
            else:
                bound = eng.try_bind(rs, t)
                if bound is None and preempt_for(rs):
                    bound = eng.try_bind(rs, t)
                if bound is None:
                    break
                self.queue.pop(0)
                slot, plan, is_complex = bound
                bucket = eng.prefill_bucket(rs)
                if is_complex:
                    # forked-prefix / chunked prompts run individually
                    flush()
                    tok = eng.start_prefill(slot, rs, plan, t)
                    emit_prefilled(rs, tok)
                else:
                    if group and group[0][2] != bucket:
                        flush()  # bucket changed: new batched forward
                    group.append((slot, rs, bucket))
            admitted += 1
        flush()

    def _harvest(self, eng) -> None:
        """Fold an engine's modeled-traffic / sharing counters into acct."""
        for k, v in eng.drain_stats().items():
            self.acct[k] += v
        self._decode_wall += eng.decode_wall_s
        eng.decode_wall_s = 0.0

    def _export_obs(self) -> None:
        """Mirror router accounting + latency samples onto the registry.

        Export-only: the acct dict (which serve-trace footers pin) is the
        source of truth; deltas since the last mirror keep repeated calls
        idempotent."""
        for k, c in self._obs_router.items():
            delta = self.acct[k] - self._obs_mirrored[k]
            if delta:
                c.inc(delta)
                self._obs_mirrored[k] = self.acct[k]
        self._obs_decode_wall.inc(self._decode_wall - self._obs_decode_wall.value)
        for rid in sorted(self.requests):
            rs = self.requests[rid]
            if getattr(rs, "_obs_observed", False):
                continue
            rs._obs_observed = True
            if rs.ttft_steps is not None:
                self._obs_ttft.observe(rs.ttft_steps)
            if rs.tpot_steps is not None:
                self._obs_tpot.observe(rs.tpot_steps)

    # ------------------------------------------------------------------
    def run(self, workload: Sequence[Request], max_steps: int = 10_000
            ) -> ServeResult:
        check_workload_fits(workload, self.ecfg)
        # open-loop release along an *accelerated* clock: each step the
        # clock advances by the traffic-spike multiplier the previous
        # step's chaos left active (1.0 when calm — then clock == t and
        # this releases exactly the per-step arrivals the legacy loop did)
        wl = sorted(workload, key=lambda req: (req.arrival_step, req.rid))
        res = ServeResult(states={}, accounting={}, n_steps=0)
        t = 0
        clock = 0.0
        nxt = 0
        pending = {req.rid for req in workload}
        while pending and t < max_steps:
            with obs.span("router.step"):
                t0 = time.perf_counter()
                arrivals: List[Request] = []
                while nxt < len(wl) and wl[nxt].arrival_step <= clock:
                    arrivals.append(wl[nxt])
                    res.arrive_step[wl[nxt].rid] = t
                    nxt += 1
                evs = self.step(t, arrivals)
                for ev in evs:
                    if ev.kind in ("complete", "shed"):
                        pending.discard(ev.req)
                t1 = time.perf_counter()
                dt = t1 - t0
                res.step_start.append(t0)
                res.step_end.append(t1)
            # one flight-recorder frame per router step (wall_s/span_s are
            # unpinned; token/queue/page counts replay bit-exactly)
            toks = sum(1 for ev in evs if ev.kind == "token")
            self.incidents.record_frame(
                t, wall_s=dt,
                span_s=sum(s for *_, s in obs.get_tracer().timeline()),
                tokens=toks, goodput=toks,
                queue_depth=len(self.queue),
                free_pages=sum(
                    self.engines[r].alloc.free_count
                    for r in sorted(self.alive)
                ),
                n_alive=len(self.alive),
            )
            clock += self._arrival_mult
            t += 1
        for r in sorted(self.alive):
            self._harvest(self.engines[r])
        self._export_obs()
        self.incidents.finalize(t)
        res.states = dict(self.requests)
        res.accounting = dict(self.acct)
        res.n_steps = t
        res.decode_wall_s = self._decode_wall
        res.snapshot_wall_s = self._snapshot_wall
        return res
