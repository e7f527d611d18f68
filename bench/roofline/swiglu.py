"""Kernel #4, SwiGLU's forward (``csrc/swiglu.cu``): the CUDA function
``swiglu_kernel``.  One launch over g, u (T, f): g and u read once, h
written once."""
from __future__ import annotations

KERNEL = "swiglu_kernel"


def work(T: int, f: int, es: int = 2):
    """(operations, HBM bytes) of one launch; ``es`` the element size."""
    return 5.0 * T * f, 3 * T * f * es
