"""``bench/roofline/`` reproduces the bound column of the port's kernel
table (PERF.md, Findings) at its shapes, to its printed digits."""
import pytest

from roofline import bound_s, flash_attention, lowrank_wgrad, swiglu


@pytest.mark.parametrize("work, printed", [
    (flash_attention.work(4, 512, 512, 16, 8, 128), "0.007512"),   # #2 (B, S, H, KV, hd)
    (flash_attention.work(8, 1024, 1024, 16, 16, 64), "0.02003"),  # #2 at the train shape
    (swiglu.work(8192, 2736), "0.04014"),                          # #4
    (lowrank_wgrad.work(8192, 1024, 2736, 64), "0.01864"),         # #6
    (lowrank_wgrad.work(8192, 2736, 1024, 64), "0.01857"),         # #6, w_down
])
def test_bounds_match_the_kernel_table(work, printed):
    ms = bound_s(*work) * 1e3
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed
