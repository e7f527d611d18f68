"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper takes the plain version for a tensor that lies on the CPU,
launches its CUDA kernel (``csrc/*.cu``) for a CUDA tensor, and raises for
anything else: there is no fallback that hides a failed build or launch.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on the current CUDA device (the kernel runs); raises
    otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"}:
        raise ValueError(f"tensors on devices {sorted(types)}: want all cpu or all cuda")
    cur = torch.cuda.current_device()
    for t in tensors:
        if t.device.index != cur:
            raise ValueError(f"tensor on {t.device}, current CUDA device is {cur}")
    return False


def check_operand(t: torch.Tensor, name: str, dtype=None) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, want {dtype}")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"dtype {t.dtype} not supported (float32 or bfloat16)")
    return code


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_FNS = {}


def kernel_fn(lib: str, fn: str, argtypes):
    """The C launch function ``fn`` of ``csrc/<lib>.cu`` with its ctypes
    signature set (loaded, and built if needed, on first use)."""
    key = (lib, fn)
    f = _FNS.get(key)
    if f is None:
        f = getattr(_build.load(lib), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[key] = f
    return f


def check_launch(lib: str, err: int) -> None:
    if err != 0:
        es = _build.load(lib).cuda_error_string
        es.argtypes = [ctypes.c_int]
        es.restype = ctypes.c_char_p
        raise RuntimeError(f"{lib} kernel launch failed: {es(err).decode()} ({err})")


# ctypes argument types of the C launch functions: every pointer and the
# stream go as void*, or ctypes would pass a 32-bit int and cut the pointer
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
