"""End-to-end training loop with MeCeFO fault tolerance (the counterpart
of ``repro.launch.train``).

Wires the substrates together: data pipeline -> training step (with NDB
masks) -> failure process -> failover controller (plan updates, step cache,
recovery accounting) -> SVD projection refresh every tau -> live state
transfer (snapshots, replicas, executed reshards) -> async checkpoints.
The step runs eagerly, so the step cache holds cheap closures where the
JAX package holds compiled executables, but it keeps the same keys.

On a data-parallel mesh (``Trainer(mesh=...)``, or the CLI under
``torchrun``) every rank runs the chaos engine, controller, recovery policy
and NDB plan alike (they are deterministic from the seed and the trace)
and computes its rows of each global batch.  Rank 0 alone writes traces,
telemetry, incident logs, obs exports and checkpoints; the replay verdict
and the exit code are agreed by an all-reduce.  Params are replicated, or
FSDP-sharded under ``ParallelConfig(fsdp=True)``, where recovery comes
from the checkpoint as in the JAX package.

CLI (reduced configs by default, on the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \\
      --mecefo dynamic --scenario high
  PYTHONPATH=src python -m repro_torch.launch.train --mecefo dynamic \\
      --chaos elastic --statexfer --trace replay \\
      tests/data/golden_trace_statexfer.jsonl --device cpu \\
      --incidents-out incidents.jsonl --obs-out obs.jsonl
  PYTHONPATH=src python -m repro_torch.obs incidents incidents.jsonl \\
      --verify tests/data/golden_incidents_statexfer.jsonl \\
      --trace tests/data/golden_trace_statexfer.jsonl --require-closed 1
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --mecefo dynamic --trace replay tests/data/golden_trace.jsonl
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import (
    MeCeFOConfig,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced,
)
from repro_torch.core.lowrank import refresh_projections
from repro_torch.core.ndb import NDBPlan, plan_to_masks
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.ft.controller import FTController
from repro_torch.ft.failures import (
    SCENARIOS,
    ChaosEngine,
    FailureScenario,
    engine_for_scenario,
)
from repro_torch.ft.injectors import CHAOS_PRESETS, Injector, chaos_preset
from repro_torch.ft.policy import make_policy, parse_policy
from repro_torch.ft.trace import (
    Trace,
    TraceRecorder,
    load_trace,
    replay_engine,
    verify_replay,
)
from repro_torch.launch.dist import destroy, init_from_env
from repro_torch.launch.state import TrainState, full_nbytes, init_state, to_local
from repro_torch.launch.steps import make_train_step, mesh_layout
from repro_torch.models.model import ExecFlags
from repro_torch.models.params import tree_leaves
from repro_torch.statexfer import StateTransferRegistry

_log = logging.getLogger("repro_torch.train")


class Trainer:
    """Fault-tolerant trainer, on one process or a data-parallel mesh.

    ``state`` starts the run from a given (whole) ``TrainState`` instead of
    the seeded init; the trainer owns it from then on (its steps update
    params and moments in place).  ``parallel`` (``configs.base.
    ParallelConfig``, default ``fsdp=False`` as in the JAX Trainer) sets
    gradient accumulation and FSDP; replicated params recover from a peer,
    FSDP-sharded ones from the checkpoint.  ``mesh``
    (``launch/mesh.py``) runs the steps data-parallel on its device, which
    then replaces ``device``.  With ``statexfer`` the
    trainer snapshots its state every ``snapshot_every`` steps to host
    replicas and executes each resize on them; restored trees are host
    copies kept in ``xfer.last_restored`` (the simulated ranks of the NDB
    plan share one state, the mesh's own rank's or its slices, so they
    never feed the training state).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        train: TrainConfig = TrainConfig(),
        parallel: Optional[Any] = None,
        mecefo: MeCeFOConfig = MeCeFOConfig(),
        scenario: FailureScenario = SCENARIOS["none"],
        n_dp: int = 4,
        n_stages: int = 8,
        step_time_s: float = 1.0,
        seed: int = 0,
        injectors: Optional[List[Injector]] = None,
        trace_record: Optional[str] = None,
        trace_replay: Optional[str] = None,
        elastic: Optional[bool] = None,
        statexfer: bool = False,
        snapshot_every: int = 1,
        ft_policy: Optional[str] = None,
        state: Optional[TrainState] = None,
        device="cuda",
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.cfg, self.shape, self.train_cfg = cfg, shape, train
        self.parallel = parallel or ParallelConfig(fsdp=False, remat="ffn", scan_layers=True)
        self.flags = ExecFlags(remat="ffn")  # the JAX Trainer's remat="ffn"
        self.mecefo = mecefo
        self.source = SyntheticLM(cfg.vocab_size)
        self.seed = seed
        self.layout = mesh_layout(cfg, mesh, self.parallel) if mesh is not None else None
        self.writes = mesh is None or mesh.rank == 0  # rank 0 alone writes files

        if state is None:
            state = init_state(cfg, train, mecefo, torch.Generator().manual_seed(seed),
                               device=self.device)
        if self.layout is not None and self.layout.sharded:
            state = to_local(state, self.layout)
        self.state = state

        # -- chaos engine: replayed trace > explicit injectors > scenario ---
        self.replay_trace = None
        recorder = TraceRecorder(trace_record) if trace_record and self.writes else None
        if trace_replay is not None:
            # a path or an already-loaded Trace
            self.replay_trace = (
                trace_replay if isinstance(trace_replay, Trace)
                else load_trace(trace_replay)
            )
            h = self.replay_trace.header
            n_dp, n_stages, step_time_s = h.n_dp, h.n_stages, h.step_time_s
            # the header's policy wins on replay: decisions must re-derive
            # from the same engine the recording ran
            ft_policy = h.policy or None
        self.policy_spec = ft_policy or ""
        if recorder is not None:
            recorder.policy = self.policy_spec
        self.controller = FTController(
            cfg=cfg, mecefo=mecefo, n_dp=n_dp, n_stages=min(n_stages, cfg.n_layers),
            global_batch=shape.global_batch, params_replicated=not self.parallel.fsdp,
        )
        self.controller.policy = make_policy(
            ft_policy,
            cost=(self.controller.incidents.mgr.cost
                  if self.controller.incidents is not None else None),
        )
        if self.replay_trace is not None:
            if self.replay_trace.header.n_stages != self.controller.n_stages:
                raise ValueError(
                    f"trace recorded for n_stages={self.replay_trace.header.n_stages}"
                    f" but this model clamps to {self.controller.n_stages}"
                )
            self.process = replay_engine(self.replay_trace, recorder=recorder)
        elif injectors is not None:
            self.process = ChaosEngine(
                n_dp, self.controller.n_stages, step_time_s,
                injectors=injectors, seed=seed + 1, recorder=recorder,
                elastic=elastic,
            )
        else:
            self.process = engine_for_scenario(
                scenario, n_dp, self.controller.n_stages, step_time_s,
                seed=seed + 1, recorder=recorder, elastic=elastic,
            )
        self.ckpt = (
            CheckpointManager(train.checkpoint_dir, layout=self.layout)
            if train.checkpoint_every
            else None
        )
        self._step_cache: Dict = {}
        self.history: List[Dict] = []
        self.refresh_s: List[float] = []  # wall time of each V1 refresh
        self._obs_step_wall = obs.histogram("train.step.wall_s")
        self._obs_steps = obs.counter("train.steps_total")
        self._logged_reshard = None

        # -- live state transfer: replicated snapshots + real reshards ------
        self.xfer = None
        self._pending_rejoin: set = set()  # ranks whose transfer is still running
        self._executed_reshard = None
        if statexfer:
            self.xfer = StateTransferRegistry(
                n_dp=self.controller.n_dp, cadence=snapshot_every,
                replicated=self.controller.params_replicated,
            )
            # accounting basis becomes the measured state size (the JAX
            # package's measure: the host-int step counts as its int32) of
            # the whole state, as the JAX package measures its global arrays
            self.controller.state_nbytes = full_nbytes(self.state, self.layout)
            if self.controller.incidents is not None:
                # rejoin incidents now close on the measured receipt,
                # not on the planned-bytes attribution
                self.controller.incidents.expect_receipts = True

    # ------------------------------------------------------------------
    def _mask_plan(self) -> NDBPlan:
        """The plan the batch masks are built from: the controller's plan
        with rejoined-but-still-transferring ranks re-detached, so masks
        flip only once a rank's state transfer has completed.  If every
        active rank is mid-transfer the plan is left ungated (gating them
        all would zero-weight the whole batch)."""
        plan = self.controller.plan
        active = set(plan.active_ranks())
        pending = self._pending_rejoin & active
        if not pending or pending == active:
            return plan
        return plan.detach(*sorted(pending))

    def _get_step(self, key):
        if key in self._step_cache:
            return self._step_cache[key]
        mode = key[0]
        kwargs = {}
        if mode == "static":
            kwargs["static_ndb"] = plan_to_masks(
                self._mask_plan(), self.cfg, self.shape.global_batch
            )
        step = make_train_step(
            self.cfg, self.train_cfg, self.mecefo, self.shape, ndb_mode=mode,
            total_steps=max(self.train_cfg.steps, 1), flags=self.flags,
            device=self.device, parallel=self.parallel, mesh=self.mesh, **kwargs,
        )
        self._step_cache[key] = step
        return step

    def _step_key(self):
        if self.mecefo.mode == "off" or self.controller.plan.is_healthy():
            return ("off",)
        if self.mecefo.mode == "dynamic":
            return ("dynamic",)
        # static mode bakes the masks: pending transfers are part of the key
        return (
            ("static",) + self.controller.compile_key()
            + tuple(sorted(self._pending_rejoin))
        )

    def _run_state_transfers(self, step_idx: int) -> None:
        """Execute any new ReshardPlan on the real state and retry gated ranks."""
        ckpt_dir = self.train_cfg.checkpoint_dir if self.ckpt else None
        rp = self.controller.last_reshard
        if self.mesh is not None and self.ckpt and (
                self.xfer.pending or (rp is not None and rp is not self._executed_reshard)):
            # every rank must see the same checkpoints: rank 0's save done
            self.ckpt.wait()
        if rp is not None and rp is not self._executed_reshard:
            self._executed_reshard = rp
            out = self.xfer.on_reshard(
                rp, self.state, step_idx,
                ckpt_like=self.state, ckpt_dir=ckpt_dir,
            )
            for receipt in out.receipts:
                self.controller.record_transfer(receipt)
        if self.xfer.pending:
            for receipt in self.xfer.retry_pending(
                step_idx, ckpt_like=self.state, ckpt_dir=ckpt_dir
            ):
                self.controller.record_transfer(receipt)
        self._pending_rejoin = set(self.xfer.pending)

    def _sync(self) -> None:
        # the step is queued asynchronously on the card: wait for it so a
        # step's wall time includes its device time.  Only the training
        # stream: a snapshot's host copy runs on a side stream beside the
        # next step, and what the trainer waits for it is counted where it
        # waits (SnapshotManager.blocked_s)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _refresh(self):
        """The new V1 tree.  Under a mesh rank 0 computes it from the whole
        params (gathered over both axes: the SVD is of each whole weight)
        and broadcasts it, so every rank holds the same bits whatever the
        SVD's determinism; each rank keeps the rows of V1 that match its
        input shard (``w_down``'s ``mlp`` rows, its experts)."""
        if self.mesh is None:
            return refresh_projections(self.state.params, self.cfg, self.mecefo.rank)
        params = self.state.params
        if self.layout.sharded:
            params = self.layout.gather_whole(params, "refresh")
        if self.mesh.rank == 0:
            proj = refresh_projections(params, self.cfg, self.mecefo.rank)
        else:
            proj = self.layout.empty_whole_proj(self.state.proj)
        for v in tree_leaves(proj):  # in leaf order: the ranks' dicts may differ in key order
            self.mesh.world_comm.broadcast(v, 0, tag="proj")
        return self.layout.cut_proj(proj)

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None, log_every: int = 10):
        steps = steps or self.train_cfg.steps
        for i in range(steps):
            with obs.span("trainer.step"):
                t0 = time.time()
                step_idx = int(self.state.step)
                outcome = self.process.step(step_idx)
                _changed, slow = self.controller.apply_chaos(outcome)
                if (self.controller.policy is not None
                        and self.process.recorder is not None):
                    # pin this step's committed decisions right after its
                    # events; replay re-derives and verifies them
                    for dec in self.controller.policy.drain():
                        self.process.recorder.record_decision(dec)
                if self.xfer is not None:
                    with obs.span("trainer.state_transfers"):
                        self._run_state_transfers(step_idx)

                batch = make_batch(
                    self.cfg, self.shape, step_idx, source=self.source, seed=self.seed
                )
                key = self._step_key()
                step = self._get_step(key)
                if key[0] == "dynamic":
                    keep, weight = plan_to_masks(
                        self._mask_plan(), self.cfg, self.shape.global_batch
                    )
                    ndb = {"keep": keep, "example_weight": weight}
                    self.state, metrics = step(self.state, batch, ndb)
                else:
                    self.state, metrics = step(self.state, batch)

                # technique III: refresh V1 every tau steps (Alg. 3)
                if (
                    self.mecefo.mode != "off"
                    and self.mecefo.lowrank_wgrad
                    and step_idx % self.mecefo.svd_period == 0
                ):
                    self._sync()
                    t_svd = time.time()
                    self.state = self.state._replace(proj=self._refresh())
                    self._sync()
                    self.refresh_s.append(time.time() - t_svd)

                if self.xfer is not None:
                    # hot-spare snapshot of the post-step state: the copy
                    # into the staging tree is queued here, the host copy
                    # runs on the worker (one cycle in flight)
                    self.xfer.on_step(self.state, step_idx, self.controller.plan)

                if self.ckpt and step_idx and step_idx % self.train_cfg.checkpoint_every == 0:
                    self.ckpt.save_async(self.state, step_idx)

                self._sync()
                dt = time.time() - t0
            self._obs_step_wall.observe(dt)
            self._obs_steps.inc()
            self.controller.observe_step_time(dt)
            if self.controller.incidents is not None:
                # one flight-recorder frame per step (wall_s/span_s/
                # snap_blocked_s are unpinned; the rest replay bit-exactly)
                self.controller.incidents.record_frame(
                    step_idx,
                    wall_s=dt,
                    span_s=sum(
                        t for *_, t in obs.get_tracer().timeline()
                    ),
                    goodput=self.controller.plan.dp_size(),
                    dp_size=self.controller.plan.dp_size(),
                    failed=len(self.controller.plan.failed),
                    pending=len(self._pending_rejoin),
                    snap_blocked_s=(
                        self.xfer.telemetry()["snapshot_blocked_s"]
                        if self.xfer is not None else None
                    ),
                )
            rec = {
                "step": step_idx,
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "seconds": dt,
                "failed": len(self.controller.plan.failed),
                "stragglers": len(slow),
                "net_inflation": outcome.net_inflation,
                "degraded_frac": self.controller.degraded_layer_fraction(),
                "dp_size": self.controller.plan.dp_size(),
                "pending_rejoin": len(self._pending_rejoin),
            }
            self.history.append(rec)
            rp = self.controller.last_reshard
            if log_every and rp is not None and rp is not self._logged_reshard:
                self._logged_reshard = rp  # each resize produces a fresh plan
                measured = ""
                if self.xfer is not None:
                    acc = self.controller.accounting
                    measured = (
                        f" measured={acc.measured_transfer_bytes/1e6:.1f}MB"
                        f" pending={sorted(self._pending_rejoin)}"
                    )
                _log.info(
                    "step %5d elastic resize: dp %d->%d dropped=%s "
                    "rejoined=%s transfer=%.1fMB (%s)%s",
                    step_idx, len(rp.old_active), rp.dp_size,
                    list(rp.dropped), list(rp.rejoined),
                    rp.transfer_bytes / 1e6, rp.source, measured,
                )
            if log_every and i % log_every == 0:
                _log.info(
                    "step %5d loss %.4f gnorm %.3f %.0fms failed=%d "
                    "slow=%d deg=%.2f dp=%d",
                    rec["step"], rec["loss"], rec["grad_norm"], dt * 1e3,
                    rec["failed"], rec["stragglers"], rec["degraded_frac"],
                    rec["dp_size"],
                )
        if self.ckpt:
            self.ckpt.wait()
        if self.xfer is not None:
            self.xfer.wait()
        if self.process.recorder is not None:
            self.process.recorder.close(
                total_steps=len(self.history),
                accounting=self.controller.accounting.as_dict(),
            )
        if self.controller.incidents is not None:
            # recovery that never completed in-trace -> unclosed: true
            self.controller.incidents.finalize(len(self.history))
        return self.history

    def replay_agreed(self) -> bool:
        """After a replay run: whether every rank's replay verified (an
        all-reduce under a mesh)."""
        bad = torch.tensor([float(bool(self.verify_replay()))], device=self.device)
        if self.mesh is not None:
            self.mesh.world_comm.all_reduce(bad, op="max", tag="verdict")
        return not bool(bad.item())

    def verify_replay(self) -> List[str]:
        """After a replay run: mismatches vs the recorded trace (empty = OK)."""
        assert self.replay_trace is not None, "trainer not in replay mode"
        return verify_replay(
            self.replay_trace, self.process,
            accounting=self.controller.accounting.as_dict(),
            decisions=(self.controller.policy.decisions
                       if self.controller.policy is not None else None),
        )

    def resume_from_checkpoint(self) -> bool:
        if not self.ckpt:
            return False
        out = self.ckpt.restore_latest(self.state)
        if out is None:
            return False
        self.state, _step = out
        return True


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-350m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mecefo", default="off", choices=["off", "static", "dynamic"])
    ap.add_argument("--scenario", default="none", choices=list(SCENARIOS))
    ap.add_argument(
        "--chaos", default=None, choices=list(CHAOS_PRESETS),
        help="chaos preset (injector bundle) layered on --scenario's rates",
    )
    ap.add_argument(
        "--trace", nargs=2, metavar=("MODE", "PATH"), default=None,
        help="'record PATH' writes a chaos trace; 'replay PATH' reproduces "
             "one bit-exactly and verifies events + accounting against it",
    )
    ap.add_argument(
        "--replay-record", metavar="PATH", default=None,
        help="while replaying, also record the replayed event stream to PATH",
    )
    ap.add_argument("--n-dp", type=int, default=4)
    ap.add_argument("--n-stages", type=int, default=8)
    ap.add_argument(
        "--statexfer", action="store_true",
        help="enable the live state-transfer subsystem: in-memory replicated "
             "snapshots, real ReshardPlan execution on rejoin, measured "
             "transfer accounting",
    )
    ap.add_argument(
        "--snapshot-every", type=int, default=1, metavar="N",
        help="statexfer snapshot cadence in steps (default 1)",
    )
    ap.add_argument(
        "--ft-policy", metavar="SPEC", default=None,
        help="recovery-policy selection: 'adaptive' (pick the cheapest "
             "path per event from CostModel estimates, priors until "
             "confident) or 'fixed:<path>' (e.g. fixed:peer_restore); "
             "default: the legacy static dispatch",
    )
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--obs-out", metavar="PATH", default=None,
        help="write run telemetry (metrics + span timeline) as JSONL to "
             "PATH, the Prometheus exposition to PATH.prom, and render the "
             "run report",
    )
    ap.add_argument(
        "--incidents-out", metavar="PATH", default=None,
        help="write the incident log (flight-recorder windows + attributed "
             "recovery costs) as JSONL to PATH; render with "
             "'python -m repro_torch.obs incidents PATH'",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    obs.logging_setup()

    trace_mode, trace_path = args.trace or (None, None)
    if trace_mode not in (None, "record", "replay"):
        ap.error(f"--trace mode must be 'record' or 'replay', got {trace_mode!r}")
    if args.replay_record and trace_mode != "replay":
        ap.error("--replay-record requires --trace replay PATH")
    if args.ft_policy is not None:
        try:
            parse_policy(args.ft_policy)
        except ValueError as e:
            ap.error(str(e))

    mesh = init_from_env(args.device)  # a torchrun rank, else None
    try:
        return _run_cli(ap, args, trace_mode, trace_path, mesh)
    finally:
        if mesh is not None:
            destroy()


def _run_cli(ap, args, trace_mode, trace_path, mesh) -> int:
    if mesh is not None and mesh.rank != 0:
        logging.getLogger("repro_torch").setLevel(logging.WARNING)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, dtype="float32")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    steps = args.steps
    replay_trace = None
    if trace_mode == "replay":
        replay_trace = load_trace(trace_path)
        if replay_trace.footer is not None:
            # replay the exact recorded run length
            steps = replay_trace.footer.total_steps
    train = TrainConfig(
        steps=steps, optimizer=args.optimizer, learning_rate=args.lr,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
    )
    mecefo = MeCeFOConfig(mode=args.mecefo, rank=16, svd_period=20)
    scenario = SCENARIOS[args.scenario]
    injectors = (
        chaos_preset(args.chaos, scenario) if args.chaos is not None else None
    )
    trainer = Trainer(
        cfg, shape, train, mecefo=mecefo,
        scenario=scenario,
        n_dp=args.n_dp, n_stages=args.n_stages,
        step_time_s=3600.0 if (args.scenario != "none" or args.chaos) else 1.0,
        seed=args.seed,
        injectors=injectors,
        trace_record=(
            trace_path if trace_mode == "record" else args.replay_record
        ),
        trace_replay=replay_trace,
        statexfer=args.statexfer,
        snapshot_every=args.snapshot_every,
        ft_policy=args.ft_policy,
        device=args.device,
        mesh=mesh,
    )
    run_meta = {
        "run": "train", "arch": args.arch,
        "mecefo": args.mecefo, "scenario": args.scenario,
        "chaos": args.chaos, "statexfer": args.statexfer,
        "ft_policy": trainer.policy_spec or None,
    }
    disarm = None
    if (args.obs_out or args.incidents_out) and trainer.writes:
        # flush-on-death: a crashed/killed run still emits partial dumps
        disarm = obs.install_crash_flush(
            obs_path=args.obs_out, incidents_path=args.incidents_out,
            incidents=trainer.controller.incidents, meta=run_meta,
        )
    hist = trainer.run()
    if disarm is not None:
        disarm()
    acc = trainer.controller.accounting
    _log.info(
        "final loss %.4f  failovers=%d recoveries=%d rank_drops=%d "
        "rejoins=%d dp=%d/%d peer_fetch=%.1fMB",
        hist[-1]["loss"], acc.n_failovers, acc.n_recoveries,
        acc.n_rank_drops, acc.n_rejoins,
        trainer.controller.plan.dp_size(), trainer.controller.n_dp,
        acc.peer_fetch_bytes / 1e6,
    )
    if trainer.xfer is not None:
        tele = trainer.xfer.telemetry()
        _log.info(
            "statexfer: %.0f snapshot cycles (%.1fMB replicated, %.1fms "
            "blocked) restores peer=%.0f ckpt=%.0f measured=%.1fMB in %.1fms",
            tele["snapshot_cycles"], tele["snapshot_bytes"] / 1e6,
            tele["snapshot_blocked_s"] * 1e3, tele["n_peer_restores"],
            tele["n_ckpt_restores"], tele["measured_transfer_bytes"] / 1e6,
            tele["transfer_s"] * 1e3,
        )
    if trace_mode == "replay":
        agreed = trainer.replay_agreed()  # a collective: every rank calls it
    if args.obs_out and trainer.writes:
        dump_path = obs.dump(args.obs_out, meta={**run_meta, "steps": len(hist)})
        _log.info("obs telemetry written to %s (+ .prom)", dump_path)
        sys.stdout.write(obs.render_report_file(dump_path))
    if args.incidents_out and trainer.controller.incidents is not None and trainer.writes:
        inc_path = obs.write_incident_log(
            args.incidents_out, trainer.controller.incidents.mgr,
            meta={**run_meta, "steps": len(hist)},
        )
        _log.info("incident log written to %s (%d incidents)", inc_path,
                  len(trainer.controller.incidents.mgr.incidents))
    if trace_mode == "record":
        _log.info("chaos trace recorded to %s (%d events)",
                  trace_path, len(trainer.process.events))
    if trace_mode == "replay":
        problems = trainer.verify_replay()
        if problems or not agreed:
            _log.error("REPLAY MISMATCH vs %s:", trace_path)
            for p in problems or ["another rank's replay did not verify"]:
                _log.error("  %s", p)
            return 1
        _log.info("REPLAY OK: %d events and accounting totals match %s",
                  len(trainer.process.events), trace_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
