"""Serving requests, deterministic workloads, and per-request metrics: a
copy of ``repro.serve.request`` (numpy only), kept in the port so that it
imports nothing of the JAX package.

A :class:`Request` is immutable (what arrived); a :class:`RequestState` is
the mutable serving-side record (emitted tokens, step-indexed latency
marks).  Workloads come from a :class:`WorkloadSpec` through an isolated
``default_rng(seed)`` stream, so both packages build the same request
sequence from one spec.  The legacy regime (every overload knob at its
default) and the scaled overload regime are both copied as they are.

Latency metrics are step-indexed: TTFT is ``first_token_step -
arrival_step`` engine steps, TPOT the mean step gap between tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    rid: int
    arrival_step: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    priority: int = 0         # higher = more important (admission order)
    deadline_steps: int = 0   # complete within arrival+deadline; 0 = none

    @property
    def total_len(self) -> int:
        """KV positions the fully-decoded request occupies."""
        return len(self.prompt) + self.max_new_tokens


@dataclass(frozen=True)
class WorkloadSpec:
    """Deterministic open-loop arrival process (seeded).

    The default values of every field below ``shared_prefix`` select the
    legacy generator regime (the original RNG stream);
    setting any of them switches to the scaled overload generator.
    """

    n_requests: int = 16
    vocab_size: int = 512
    seed: int = 0
    mean_interarrival_steps: float = 1.0
    prompt_len: Tuple[int, int] = (4, 24)   # inclusive [lo, hi]
    new_tokens: Tuple[int, int] = (4, 32)   # inclusive [lo, hi]
    shared_prefix: int = 0  # common prompt prefix length (COW page sharing)
    # -- scaled-workload knobs (defaults = legacy regime) ---------------
    arrival: str = "poisson"      # "poisson" | "bursty" | "diurnal"
    burst_factor: float = 4.0     # arrival-rate multiplier inside a burst
    burst_period: int = 64        # steps between burst onsets (or day length)
    burst_duty: float = 0.25      # fraction of the period spent bursting
    length_dist: str = "uniform"  # "uniform" | "longtail" (log-normal)
    n_prefix_groups: int = 0      # distinct "system prompt" populations
    # ((priority, weight, deadline_steps), ...); empty = all priority 0
    priority_classes: Tuple[Tuple[int, float, int], ...] = ()

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.length_dist not in ("uniform", "longtail"):
            raise ValueError(f"unknown length_dist {self.length_dist!r}")
        if self.n_prefix_groups > 0 and self.shared_prefix <= 0:
            raise ValueError("n_prefix_groups needs shared_prefix > 0")

    @property
    def scaled(self) -> bool:
        """True when any overload knob leaves the legacy regime."""
        return (
            self.arrival != "poisson"
            or self.length_dist != "uniform"
            or self.n_prefix_groups > 0
            or bool(self.priority_classes)
        )

    def to_json(self) -> dict:
        d = {
            "n_requests": self.n_requests, "vocab_size": self.vocab_size,
            "seed": self.seed,
            "mean_interarrival_steps": self.mean_interarrival_steps,
            "prompt_len": list(self.prompt_len),
            "new_tokens": list(self.new_tokens),
            "shared_prefix": self.shared_prefix,
        }
        if self.scaled:  # legacy specs serialize without the overload knobs
            d.update(
                arrival=self.arrival, burst_factor=self.burst_factor,
                burst_period=self.burst_period, burst_duty=self.burst_duty,
                length_dist=self.length_dist,
                n_prefix_groups=self.n_prefix_groups,
                priority_classes=[list(c) for c in self.priority_classes],
            )
        return d

    @classmethod
    def from_json(cls, d: dict) -> "WorkloadSpec":
        return cls(
            n_requests=int(d["n_requests"]), vocab_size=int(d["vocab_size"]),
            seed=int(d["seed"]),
            mean_interarrival_steps=float(d["mean_interarrival_steps"]),
            prompt_len=tuple(d["prompt_len"]),
            new_tokens=tuple(d["new_tokens"]),
            shared_prefix=int(d.get("shared_prefix", 0)),
            arrival=str(d.get("arrival", "poisson")),
            burst_factor=float(d.get("burst_factor", 4.0)),
            burst_period=int(d.get("burst_period", 64)),
            burst_duty=float(d.get("burst_duty", 0.25)),
            length_dist=str(d.get("length_dist", "uniform")),
            n_prefix_groups=int(d.get("n_prefix_groups", 0)),
            priority_classes=tuple(
                (int(p), float(w), int(dl))
                for p, w, dl in d.get("priority_classes", ())
            ),
        )


def _rate_mult(spec: WorkloadSpec, t: float) -> float:
    """Arrival-rate multiplier at nominal time ``t`` (>= a small floor)."""
    if spec.arrival == "bursty":
        # square wave: the first `burst_duty` fraction of each period runs
        # `burst_factor`× hot, the rest at the nominal rate
        phase = (t % spec.burst_period) / spec.burst_period
        return spec.burst_factor if phase < spec.burst_duty else 1.0
    if spec.arrival == "diurnal":
        # sinusoidal day: peak `burst_factor`× at mid-period, trough near 0
        phase = (t % spec.burst_period) / spec.burst_period
        peak = 0.5 * (1.0 - math.cos(2.0 * math.pi * phase))
        return max(spec.burst_factor * peak, 0.1)
    return 1.0


def _draw_len(rng: np.random.Generator, lo: int, hi: int, dist: str) -> int:
    if dist == "longtail" and hi > lo:
        # log-normal body with most mass near `lo`, clipped at `hi` — the
        # classic many-short / few-very-long serving length profile
        x = lo + rng.lognormal(mean=0.0, sigma=1.0) * 0.15 * (hi - lo)
        return int(min(int(x), hi))
    return int(rng.integers(lo, hi + 1))


def build_workload(spec: WorkloadSpec) -> List[Request]:
    """Requests in arrival order, a pure function of the spec.

    ``shared_prefix > 0`` prepends one common seeded token run to every
    prompt (the "same system prompt" workload the COW prefix sharing
    dedups); with ``n_prefix_groups > 1`` each request instead draws one of
    several distinct prefix populations.  ``prompt_len`` bounds the
    per-request unique tail.  Legacy specs (``spec.scaled == False``)
    consume the exact same RNG stream as before the overload knobs existed.
    """
    rng = np.random.default_rng(spec.seed)
    prefix: Tuple[int, ...] = ()
    prefixes: List[Tuple[int, ...]] = []
    if spec.n_prefix_groups > 0:
        prefixes = [
            tuple(
                int(x) for x in
                rng.integers(0, spec.vocab_size, size=spec.shared_prefix)
            )
            for _ in range(spec.n_prefix_groups)
        ]
    elif spec.shared_prefix > 0:
        prefix = tuple(
            int(x)
            for x in rng.integers(0, spec.vocab_size, size=spec.shared_prefix)
        )
    classes = spec.priority_classes
    weights = None
    if classes:
        w = np.asarray([c[1] for c in classes], np.float64)
        weights = w / w.sum()
    t = 0.0
    out: List[Request] = []
    for rid in range(spec.n_requests):
        # non-homogeneous Poisson by thinning-free rate scaling: the gap
        # shrinks by the rate multiplier at the current nominal time
        gap = rng.exponential(spec.mean_interarrival_steps)
        if spec.arrival != "poisson":
            gap /= _rate_mult(spec, t)
        t += gap
        plen = _draw_len(rng, *spec.prompt_len, spec.length_dist)
        gen = _draw_len(rng, *spec.new_tokens, spec.length_dist)
        if prefixes:
            group = int(rng.integers(len(prefixes)))
            head = prefixes[group]
        else:
            head = prefix
        prompt = head + tuple(
            int(x) for x in rng.integers(0, spec.vocab_size, size=plen)
        )
        prio, deadline = 0, 0
        if classes:
            c = classes[int(rng.choice(len(classes), p=weights))]
            prio, deadline = int(c[0]), int(c[2])
        out.append(Request(rid, int(t), prompt, gen,
                           priority=prio, deadline_steps=deadline))
    return out


@dataclass
class RequestState:
    """One request's life on the serving side.

    Invariant: ``cur_len`` (valid KV positions written) equals
    ``len(prompt) + len(emitted) - 1`` once the prefill has emitted the
    first token — each decode round consumes the last emitted token (writes
    its K/V at ``cur_len``) and emits the next.
    """

    req: Request
    emitted: List[int] = field(default_factory=list)
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    last_token_step: Optional[int] = None
    token_steps: List[int] = field(default_factory=list)
    n_migrations: int = 0
    n_preemptions: int = 0
    replayed_tokens: int = 0
    restored_bytes: int = 0
    shed: bool = False  # dropped by deadline-aware admission, never served
    # how the prompt's K/V were first built (the port's engine records it at
    # admission; the replay restore path rebuilds the same bits from it);
    # not in the JAX package's record
    prefill_recipe: Optional[tuple] = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.req.max_new_tokens

    @property
    def cur_len(self) -> int:
        return len(self.req.prompt) + max(len(self.emitted) - 1, 0)

    @property
    def good(self) -> bool:
        """Completed within its deadline (goodput numerator)."""
        if not self.done or self.shed:
            return False
        if self.req.deadline_steps <= 0:
            return True
        return (
            self.last_token_step
            <= self.req.arrival_step + self.req.deadline_steps
        )

    def record_token(self, token: int, step: int) -> None:
        self.emitted.append(int(token))
        self.token_steps.append(step)
        if self.first_token_step is None:
            self.first_token_step = step
        self.last_token_step = step

    # -- step-indexed latency metrics ----------------------------------
    @property
    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.req.arrival_step

    @property
    def tpot_steps(self) -> Optional[float]:
        if self.first_token_step is None or len(self.emitted) < 2:
            return None
        span = self.last_token_step - self.first_token_step
        return span / (len(self.emitted) - 1)
