"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper takes the plain version for a tensor that lies on the CPU,
launches its CUDA kernel (``csrc/*.cu``) for a CUDA tensor, and raises for
anything else: there is no fallback that hides a failed build or launch.
Inside ``with plain_versions():`` every wrapper takes its plain version on
any device, which is how the parity checks run the plain path on the card.
Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, where it calls its kernel and nowhere else.  Every
launch function also books its launch's work with each listening recorder
(``launch/cost.py``) through :func:`book`: its operations and the HBM
bytes it must move, from the shapes by the same arithmetic as
``chip_smoke.py``'s bound rows.

On the meta device (the dry run, ``launch/dryrun.py``) a wrapper takes its
kernel's route: the launch function checks its operands, makes its
outputs (uninitialized, of the kernel's shapes), books the launch, and
calls nothing, so ``<wrapper>.launches`` stays as it was.  A backward that recomputes the plain version
(#2, #3) recomputes it on meta too, so the dry run books what the card
runs.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# a module global, not a thread-local: autograd runs CUDA backwards (and
# the recomputes inside them) on its own threads
_PLAIN = False


@contextlib.contextmanager
def plain_versions():
    """Every wrapper takes its plain version while the block runs, forward
    and backward alike, on any device."""
    global _PLAIN
    was, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = was


def runs_plain(*tensors: torch.Tensor) -> bool:
    """True when the plain version runs: every tensor lies on the CPU, or
    :func:`plain_versions` is active.  False when all lie on the current
    CUDA device (the kernel runs) or all on the meta device (the kernel's
    route, shapes only); raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"meta"}:
        return _PLAIN
    if types != {"cuda"}:
        raise ValueError(f"tensors on devices {sorted(types)}: want all cpu, all cuda or "
                         "all meta")
    cur = torch.cuda.current_device()
    for t in tensors:
        if t.device.index != cur:
            raise ValueError(f"tensor on {t.device}, current CUDA device is {cur}")
    return _PLAIN


# How a plain version carries an f32 intermediate P (the probabilities of
# flash attention, x @ V1 of the low-rank Wgrad) into its second product:
# "f32" as the reference does; "split" as the bf16 tensor-core kernels do,
# P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi) and one f32
# product each (P to ~2^-17 relative); "bf16" rounds P once, the precision
# the checks must catch.
P_PRECISIONS = ("f32", "split", "bf16")


def p_terms(p: torch.Tensor, precision: str = "f32") -> list:
    """The f32 terms whose products with the second operand the plain
    version sums, for P in ``precision`` (one of :data:`P_PRECISIONS`)."""
    if precision == "f32":
        return [p]
    if precision == "bf16":
        return [p.to(torch.bfloat16).float()]
    if precision == "split":
        hi = p.to(torch.bfloat16).float()
        return [hi, (p - hi).to(torch.bfloat16).float()]
    raise ValueError(f"P precision {precision!r} not in {P_PRECISIONS}")


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


def kernel_fn(lib: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C function ``fn`` of ``csrc/<lib>.cu`` with its ctypes signature
    set (loaded, and built if needed, on first use)."""
    key = (lib, fn)
    f = _FNS.get(key)
    if f is None:
        f = getattr(_build.load(lib), fn)
        f.argtypes = argtypes
        f.restype = restype
        _FNS[key] = f
    return f


def check_launch(lib: str, err: int, kernel: str = "") -> None:
    """Raise on a launch function's error code; ``kernel`` names the kernel
    where it is not ``csrc/<lib>.cu``'s own."""
    if err != 0:
        es = _build.load(lib).cuda_error_string
        es.argtypes = [ctypes.c_int]
        es.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel or lib} kernel launch failed: {es(err).decode()} ({err})")


# ctypes argument types of the C launch functions: every pointer and the
# stream go as void*, or ctypes would pass a 32-bit int and cut the pointer
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_detach(name: str, *tensors: torch.Tensor) -> None:
    """A bare CUDA launch writes into a fresh tensor that autograd knows
    nothing of; under grad that would silently cut every gradient upstream.
    The launch functions call this first, so only their
    ``torch.autograd.Function`` (whose forward runs with grad off) or a
    caller under ``torch.no_grad()`` reaches the kernel."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the bare CUDA launch would return a tensor without autograd "
            f"history; call the wrapper {name}() (it goes through its autograd "
            "Function) or run under torch.no_grad()"
        )


def recompute_grads(plain, saved, needs, grad_out, *consts):
    """Backward of a kernel's Function: differentiate its plain version,
    recomputed from the saved inputs, at ``grad_out``.

    ``needs`` is ``ctx.needs_input_grad`` for the tensor inputs; returns
    one gradient (or None) per tensor input.
    """
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*xs, *consts)
    want = [x for x, n in zip(xs, needs) if n]
    grads = iter(torch.autograd.grad(out, want, grad_out) if want else ())
    return tuple(next(grads) if n else None for n in needs)


# the recorders listening to launches (``launch/cost.py:CostMode`` adds
# itself while it runs); each has ``kernel(name, ops, nbytes)``
RECORDERS: list = []


def on_meta(t: torch.Tensor) -> bool:
    """True for a tensor of the meta device: the launch makes its outputs
    and calls nothing."""
    return t.device.type == "meta"


def book(name: str, cost) -> None:
    """Book one launch of kernel ``name`` with every recorder, on the card
    or on meta: ``cost()`` gives (operations, HBM bytes), called only while
    a recorder listens."""
    if RECORDERS:
        ops, nbytes = cost()
        for r in RECORDERS:
            r.kernel(name, float(ops), int(nbytes))


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
