#!/usr/bin/env python3
"""The benchmark of the port (``repro_torch``): one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration
(``bench/configs/``) under a traffic mix (``bench/traffic/``).  A run:

1. builds, or finds built, the kernels a training step launches (the
   program's build directory inside the checkout), and compiles, or finds
   compiled, the Python byte code of what it imports
   (``.bench_cache/pycache`` inside the checkout);
2. makes the stage's weights on the card from the seed
   (``bench/weights.py``);
3. in a neighbour cell, refreshes V1 with the program's
   ``refresh_projections`` (``v1_refresh_s``);
4. runs the step on batches 0 and 1 of the seed (``bench/traffic.py``)
   and keeps what the check compares: each step's loss, the first clipped
   gradient's norm a leaf (from AdamW's first moment) and the parameters'
   change after the two steps; then one more step (batch 2): the window
   uses no shape, kernel or buffer these have not;
5. resets the peak-memory counter and drives the same step object, back
   to back, on batches 3, 4, ... for ``--seconds`` of host clock, then
   synchronises once (under ``torch.profiler`` with ``--trace 1``);
6. frees the program's state and runs the plain reference
   (``bench/reference/``) over the same two steps (``bench/check.py``);
7. prints each compared number beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output.

It exits non-zero, printing no result, without a card (or fewer than the
cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the
JAX package) is loaded once the window has closed.  With ``--calibrate``
it needs no limits file and prints no result: only the compared numbers
and each side's readings (a ``readings`` JSON line on standard error),
from which a cell's limits are set.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The byte code of every module a run imports, torch's included, is kept at
# a fixed place in the checkout, so that only a checkout's first run compiles
# Python source: an installation may ship no byte code and forbid writing it,
# and then torch's imports, ~850 of them in the first step alone, compiled
# again in every run take 10-15 s of set-up and most of its spread.
sys.pycache_prefix = os.path.join(ROOT, ".bench_cache", "pycache")
sys.dont_write_bytecode = False
for _p in (os.path.join(ROOT, "src"), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import check  # noqa: E402
import spec  # noqa: E402
from traffic import Batches  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECKED_STEPS = 2
WARMUP_STEPS = 1


def reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, root: str = ROOT,
             bench_dir: str = HERE, program=None, t_start: float = T0):
    """One run of ``cell``: the result's fields and the checks' rows.
    ``program`` makes the system under test (``bench/program.py``'s
    ``Program`` by default; the fault tests pass a broken one)."""
    import torch

    from reference.model import Reference, Stage

    if program is None:
        from program import Program as program
    from program import launches

    dev = torch.device(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        from program import build_kernels

        build_kernels()
    marks.append(("build", time.perf_counter()))
    spans = {}
    batches = Batches(cell.traffic, cell.sizes["vocab"], seed)
    prog = program(cell, seed, dev, spans, time.perf_counter)
    marks.append(("program", time.perf_counter()))
    got = {"loss": []}
    for i in range(CHECKED_STEPS):
        got["loss"].append(float(prog.step(batches(i))["loss"]))
        marks.append((f"step{i}", time.perf_counter()))
        if i == 0:
            got["grad"] = prog.first_grad_norms()
    got["change"] = prog.change_norms()
    marks.append(("change", time.perf_counter()))
    for i in range(CHECKED_STEPS, CHECKED_STEPS + WARMUP_STEPS):
        prog.step(batches(i))
    _sync(dev)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("setup phases (s): " + ", ".join(
        f"{n} {t - t0:.3f}" for (_, t0), (n, t) in zip(marks, marks[1:]))
        + "".join(f", of which {k} {v:.3f}" for k, v in spans.items()), file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = launches()

    def window():
        i = CHECKED_STEPS + WARMUP_STEPS
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("bench.batch"):
                batch = batches(i)
            with torch.profiler.record_function("bench.step"):
                prog.step(batch)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        return i - CHECKED_STEPS - WARMUP_STEPS, time.perf_counter() - t0

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from devtrace import Trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as p:
            with torch.profiler.record_function("bench.window"):
                steps, wall = window()
        tr = Trace(p.profiler.kineto_results.events())
        del p
    else:
        steps, wall = window()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    done = {k: v - before[k] for k, v in launches().items()}
    prog.free()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = cell.traffic
    ref = Reference(Stage(cell.sizes, t["train"], t["ndb_mode"], int(t["mecefo"]["rank"])),
                    seed, dev).readings(batches, CHECKED_STEPS)
    numbers = check.compare(got, ref)
    ok, rows = check.verdict(numbers, cell.limits)
    print("readings " + json.dumps({"program": got, "reference": ref}), file=sys.stderr)
    for key, gaps in check.leaf_gaps(got, ref).items():
        print(f"{key} gap by leaf: " + ", ".join(f"{p} {g:.3g}" for p, g in gaps.items()),
              file=sys.stderr)
    print(f"loss program {got['loss']} reference {ref['loss']}", file=sys.stderr)
    if trace:
        run = SimpleNamespace(cell=cell, sizes=cell.sizes, steps=steps, window_s=tr.window_s,
                              trace=tr, spans=spans, launches=done)
        metrics = {}
        for e in spec.cell_metrics(root, cell.name, "per_layer"):
            v = reader(e["name"], bench_dir)(run)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        values = {"tokens_per_s": steps * cell.tokens_per_step / wall,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
                   for e in spec.cell_metrics(root, cell.name, "end_to_end")}
    out = {"correct": ok, "attempted": steps,
           "failed": check.failed(rows),
           "metrics": metrics, "peak": peak, "steps": steps, "window_s": wall}
    if tr is not None:
        out["trace"] = tr
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", action="store_true",
                    help="read the compared numbers without limits; print no result")
    args = ap.parse_args(argv)
    import torch

    cell = spec.load_cell(ROOT, args.workload, calibrate=args.calibrate)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} found", file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip() or smi.stderr.strip()
    except OSError as e:  # no nvidia-smi on the path
        card = f"{torch.cuda.get_device_name(0)}, power limit unknown ({e})"
    print(f"card: {card}", file=sys.stderr, flush=True)
    res, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}", file=sys.stderr)
        return 3
    if args.calibrate:
        for n, v, lim in rows:
            print(f"calibrate {n} {v!r} limit {lim!r}", file=sys.stderr)
        return 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "trace" in res:
        tr = res["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.breakdown()
    # a NaN reads as inf in the check; JSON holds neither
    line["checks"] = {n: {"value": min(v, 1e300), "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
