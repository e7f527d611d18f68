#!/usr/bin/env python3
"""The control and the planted faults of a cell's check, read on the card
at the cell's own sizes (not run by the benchmark's runs).

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--out FILE]

For each seed it runs the plain reference (``bench/reference/model.py``)
three times over the check's two steps: in float32 (the reference), in
float8 e4m3 (the control: the reference in the precision below the
configuration's bfloat16) and over half of the batch with the mean taken
over the rest (a fault planted in the reference put in the program's
place).  It prints one JSON line a seed with the check's numbers
(``bench/check.py``) of the control and of the fault against the
reference, each judged by the cell's own limits (``correct`` has to come
out false), and that verdict on standard error.  A step that returns its
state unchanged needs no run: its parameters' change is 0, which reads 1
by the check's measure.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import check  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402
from traffic import Batches  # noqa: E402


def readings(cell, seed: int, device, precision: str = "f32", rows=None):
    import torch

    from reference.model import Reference, Stage

    t = cell.traffic
    ref = Reference(Stage(cell.sizes, t["train"], t["ndb_mode"], int(t["mecefo"]["rank"])),
                    seed, torch.device(device), precision, rows)
    out = ref.readings(Batches(t, cell.sizes["vocab"], seed), run.CHECKED_STEPS)
    del ref
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _against(got, ref, limits) -> dict:
    """The check's numbers of ``got`` against ``ref``, judged by the cell's
    own limits (``check.verdict``), with each step's loss gap, each leaf's
    gap and ``got``'s readings beside them."""
    out = check.compare(got, ref)
    ok, rows = check.verdict(out, limits)
    out["correct"] = ok
    out["failed"] = [n for n, v, lim in rows if lim is None or not v <= lim]
    out["loss_by_step"] = [abs(p - r) / abs(r) for p, r in zip(got["loss"], ref["loss"])]
    out["by_leaf"] = check.leaf_gaps(got, ref)
    out["readings"] = got
    return out


def control(cell, seed: int, device="cuda") -> dict:
    t0 = time.perf_counter()
    ref = readings(cell, seed, device)
    t_ref = time.perf_counter() - t0
    half = slice(0, cell.batch // 2)
    lim = cell.limits
    return {"seed": seed, "reference_s": t_ref, "reference": ref,
            "control_fp8": _against(readings(cell, seed, device, "fp8"), ref, lim),
            "fault_half_batch": _against(readings(cell, seed, device, rows=half), ref, lim)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--calibrate", action="store_true",
                    help="a cell without a limits file: every number reads as failing")
    args = ap.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload, calibrate=args.calibrate)
    for seed in args.seeds:
        got = control(cell, seed)
        line = json.dumps(dict(got, workload=args.workload))
        print(line, flush=True)
        for key in ("control_fp8", "fault_half_batch"):
            c = got[key]
            print(f"{args.workload} seed {seed} {key}: correct {c['correct']}, failing "
                  f"{', '.join(c['failed']) or 'nothing'} ("
                  + ", ".join(f"{n} {c[n]:.3g} limit {cell.limits.get(n)}" for n in check.NUMBERS)
                  + ")", file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
