"""The harness on a card: the tiny cells through the port's CUDA kernels
(f32), against the plain reference, and a traced run's readers."""
import pytest
from conftest import TINY_CELLS, run_tiny

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", TINY_CELLS)
def test_tiny_cells_are_correct_on_the_card(tiny_root, card, name):
    res, rows = run_tiny(tiny_root, name, device=card.type)
    assert res["correct"], rows
    assert res["metrics"]["peak_mem_gib"]["value"] > 0


def test_a_traced_run_reads_the_device(tiny_root, card):
    res, _ = run_tiny(tiny_root, "tiny-dense.neighbor", trace=True, device=card.type)
    tr = res["trace"]
    assert 0 < tr.busy_s <= tr.window_s
    assert "roofline.flash_attention" in res["metrics"]
    assert 0 < res["metrics"]["roofline.flash_attention"]["value"] < 105
