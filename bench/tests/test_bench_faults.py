"""The check fails what it must: a run of the harness, its look for a card
skipped, with the timed path broken underneath comes out not correct,
once for each fault a training cell can have on one chip (a step that
returns its state unchanged; half of the batch left out, the mean taken
over the rest), and the control (the reference in float8 in the program's
place) reads far above the program's own gaps.  At the tiny size; the
readings at the cells' sizes are ``bench/control.py``'s, on the card."""
import numpy as np
import pytest
from conftest import TINY_CELLS, TINY_LIMITS, run_tiny

import check
import control
import spec
from program import Program


class Unchanged(Program):
    """A step that computes and returns its state unchanged."""

    def step(self, batch):
        _state, metrics = self.step_fn(self.state, batch)
        return metrics


class HalfBatch(Program):
    """A step over the first half of the batch: the second half's rows
    replaced by the first half's, so the mean runs over the first half."""

    def step(self, batch):
        half = {k: np.concatenate([v[: len(v) // 2]] * 2) for k, v in batch.items()}
        return super().step(half)


@pytest.mark.parametrize("name", TINY_CELLS)
@pytest.mark.parametrize("fault", [Unchanged, HalfBatch])
def test_a_broken_step_is_not_correct(tiny_root, name, fault):
    sound, _ = run_tiny(tiny_root, name)
    broken, rows = run_tiny(tiny_root, name, program=fault)
    assert sound["correct"]
    assert not broken["correct"] and broken["failed"] >= 1, rows


@pytest.mark.parametrize("name", TINY_CELLS)
def test_the_control_and_the_half_batch_fail_the_limits(tiny_root, name):
    cell = spec.load_cell(tiny_root, name, tiny_root + "/bench")
    assert cell.limits == TINY_LIMITS
    got = control.control(cell, 7, "cpu")
    for key in ("control_fp8", "fault_half_batch"):
        assert not got[key]["correct"] and got[key]["failed"], (key, got[key])


def _readings(grad, change):
    return {"loss": [2.0, 1.9], "grad": grad, "change": change}


REF = _readings({"embed": 1.0, "wq": 0.0, "w_up": 2.0, "w_down": 1.5, "ln": 1e-3},
                {"embed": 0.1, "wq": 1e-6, "w_up": 0.2, "w_down": 0.15, "ln": 0.0})
LIMITS = {"loss": 1e-4, "grad": 2e-3, "grad_leaf": 1e-2, "change": 1e-3}


def test_grad_leaf_sees_a_small_leaf_that_grad_reads_loosely():
    """An RMSNorm gain's gradient (1e-3 of the median leaf's) wrong by
    100 %: ``grad`` reads 1e-3, under its limit; ``grad_leaf`` reads 1.
    A leaf with no gradient in the reference is held by ``grad`` alone."""
    prog = _readings(dict(REF["grad"], ln=2e-3), dict(REF["change"]))
    nums = check.compare(prog, REF)
    assert nums["grad"] == pytest.approx(1e-3 / 1.0)
    assert nums["grad_leaf"] == pytest.approx(1.0)
    assert "wq" not in check.leaf_gaps(prog, REF)["grad_leaf"]
    ok, rows = check.verdict(nums, LIMITS)
    assert not ok and check.failed(rows) == 1
    assert check.verdict(check.compare(REF, REF), LIMITS)[0]
    stray = check.compare(_readings(dict(REF["grad"], wq=0.5), REF["change"]), REF)
    assert stray["grad"] == pytest.approx(0.5 / 1.0) and stray["grad_leaf"] == 0.0


def test_a_number_without_a_limit_fails_and_a_stray_limit_raises():
    nums = check.compare(REF, REF)
    for n in check.NUMBERS:
        ok, rows = check.verdict(nums, {k: v for k, v in LIMITS.items() if k != n})
        assert not ok and check.failed(rows) == 1, n
    ok, rows = check.verdict(nums, {})
    assert not ok and check.failed(rows) == len(check.NUMBERS)
    with pytest.raises(ValueError, match="grad_norm"):
        check.verdict(nums, dict(LIMITS, grad_norm=1e-3))
