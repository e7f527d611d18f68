"""The plain reference agrees with the port's plain paths at a tiny size in
f32: the healthy and the neighbour program, dense and MoE, over three
steps (each step's loss, the first clipped gradient and the parameters'
change by leaf)."""
import time

import pytest
import torch
from conftest import TINY_CELLS, run_tiny

import check
import spec
from program import Program
from reference.model import Reference, Stage
from traffic import Batches


@pytest.mark.parametrize("name", TINY_CELLS)
def test_reference_agrees_with_the_program_in_f32(tiny_root, name):
    cell = spec.load_cell(tiny_root, name, tiny_root + "/bench")
    seed, dev = 2 ** 31 + 3, torch.device("cpu")
    prog = Program(cell, seed, dev, {}, time.perf_counter)
    batches = Batches(cell.traffic, cell.sizes["vocab"], seed)
    got = {"loss": []}
    for i in range(3):
        got["loss"].append(float(prog.step(batches(i))["loss"]))
        if i == 0:
            got["grad"] = prog.first_grad_norms()
    got["change"] = prog.change_norms()
    t = cell.traffic
    ref = Reference(Stage(cell.sizes, t["train"], t["ndb_mode"], t["mecefo"]["rank"]), seed,
                    dev).readings(batches, 3)
    n = check.compare(got, ref)
    assert n["loss"] < 1e-6 and n["grad"] < 1e-5 and n["change"] < 1e-4, n
    # the neighbour's MHA leaves get no gradient on either side
    if t["ndb_mode"] == "degraded":
        assert ref["grad"]["layers.0.mixer.wq"] == got["grad"]["layers.0.mixer.wq"] == 0.0


def test_a_sound_run_is_correct(tiny_root):
    res, rows = run_tiny(tiny_root, "tiny-dense.neighbor")
    assert res["correct"] and all(lim is not None for _n, _v, lim in rows)
