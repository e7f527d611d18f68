"""What one rank's step costs, counted as it runs (the counterpart of
``repro.launch.hlo_cost``, which walks the compiled HLO instead).

:class:`CostMode` is a ``TorchDispatchMode`` over a step's forward and
backward.  Per rank it counts:

- **operations**: each product by ``torch.utils.flop_counter``'s formulas
  (``mm``, ``bmm``, ``addmm``, ...), each of the port's kernels by its own
  count (``kernels/__init__.py:book``, the arithmetic of
  ``chip_smoke.py``'s bound rows); other aten ops count none;
- **HBM bytes**: each aten op's distinct input tensors plus the outputs
  that are not among them (an in-place result counts once), a kernel as
  one op with its own count; an op that only re-views its inputs (a view,
  ``_unsafe_view``, ``detach``) and an allocation that writes nothing
  (``empty``, ``empty_like``, ``new_empty``) move none.  This is the port's
  analogue of the reference's fused-op byte model: eager PyTorch fuses
  nothing but the kernels;
- **collective bytes**, by kind and tag and by kind and group, from the
  collectives' counters (``parallel/collectives.py``) over the run;
- **launches** by kernel;
- **peak live bytes**: the storages alive at once, each counted when an op
  first returns it and uncounted when it is freed; the tensors named
  ``live`` (parameters, optimizer state, inputs) count from the start.

The counts depend on the ops, their shapes and dtypes and the kernels'
shapes alone, so a step on the meta device (``launch/dryrun.py``) and the
same step on the card count the same operations, bytes and launches; the
card's allocator adds its rounding and library workspaces to the peak.
While it counts, autograd runs the backward on the calling thread, so the
frees come in the same order on every device.
"""
from __future__ import annotations

import copy
import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.parallel import collectives

aten = torch.ops.aten

# allocations that write nothing
_ALLOC = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
          aten.new_empty.default, aten.new_empty_strided.default}


@dataclass
class Cost:
    """What :class:`CostMode` counted (the module docstring)."""

    flops: float = 0.0              # products and kernels
    bytes: int = 0                  # HBM bytes, aten ops and kernels
    kernel_flops: float = 0.0       # the kernels' share of ``flops``
    kernel_bytes: int = 0           # the kernels' share of ``bytes``
    n_ops: int = 0                  # aten ops that moved bytes
    launches: Dict[str, int] = field(default_factory=dict)
    kernel_work: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collectives: Dict[str, Dict[str, Dict[str, int]]] = field(default_factory=dict)
    collectives_by_group: Dict[str, Dict[str, Dict[str, int]]] = field(default_factory=dict)
    start_bytes: int = 0            # the live tensors' storages at the start
    peak_bytes: int = 0

    @property
    def collective_bytes(self) -> int:
        return sum(e["bytes"] for tags in self.collectives.values() for e in tags.values())


def tensors_of(tree) -> list:
    """The tensors of a tree of dicts, tuples, lists and NamedTuples."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def _diff(after, before) -> Dict[str, Dict[str, Dict[str, int]]]:
    out = {}
    for kind, tags in after.items():
        for tag, e in tags.items():
            b = before.get(kind, {}).get(tag, {"calls": 0, "bytes": 0})
            if e["calls"] != b["calls"]:
                out.setdefault(kind, {})[tag] = {"calls": e["calls"] - b["calls"],
                                                  "bytes": e["bytes"] - b["bytes"]}
    return out


class CostMode(TorchDispatchMode):
    """Counts a run's cost (the module docstring); read :attr:`cost` after
    the ``with`` block.  ``live``: a tree of the tensors alive from the
    start."""

    def __init__(self, live=()):
        super().__init__()
        self.cost = Cost()
        self._work = defaultdict(lambda: [0.0, 0])
        self._launches = Counter()
        self._held: Dict[int, tuple] = {}  # id(storage) -> (weakref, nbytes)
        self._live = 0
        for t in tensors_of(live):
            self._hold(t)
        self.cost.start_bytes = self.cost.peak_bytes = self._live

    # storages -------------------------------------------------------------

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)), n)
        self._live += n
        if self._live > self.cost.peak_bytes:
            self.cost.peak_bytes = self._live

    def _free(self, key: int) -> None:
        entry = self._held.pop(key, None)
        if entry is not None:
            self._live -= entry[1]

    # recorder of kernels (kernels/__init__.py:book) -----------------------

    def kernel(self, name: str, ops: float, nbytes: int) -> None:
        self._launches[name] += 1
        w = self._work[name]
        w[0] += ops
        w[1] += nbytes
        self.cost.kernel_flops += ops
        self.cost.kernel_bytes += nbytes
        self.cost.flops += ops
        self.cost.bytes += nbytes

    # the dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.cost.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        ins = _unique(tensors_of((args, kwargs)))
        outs = [t for t in tensors_of(out) if not any(t is i for i in ins)]
        if func not in _ALLOC and not _reviews(func, ins, outs):
            self.cost.n_ops += 1
            self.cost.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in tensors_of(out):
            self._hold(t)
        return out

    def __enter__(self):
        self._before = (copy.deepcopy(collectives.counts()),
                        copy.deepcopy(collectives.group_counts()))
        kernels.RECORDERS.append(self)
        # the backward on this thread (a CUDA backward runs on autograd's own
        # otherwise): the same ops in the same order on every device
        self._threads = torch.autograd.set_multithreading_enabled(False)
        self._threads.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._threads.__exit__(*exc)
            kernels.RECORDERS.remove(self)
            self.cost.launches = dict(self._launches)
            self.cost.kernel_work = {k: {"flops": w[0], "bytes": w[1]}
                                     for k, w in self._work.items()}
            self.cost.collectives = _diff(collectives.counts(), self._before[0])
            self.cost.collectives_by_group = _diff(collectives.group_counts(), self._before[1])


def _unique(ts: list) -> list:
    out = []
    for t in ts:
        if not any(t is u for u in out):
            out.append(t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reviews(func, ins: list, outs: list) -> bool:
    """True for an op that only re-views its inputs: a view, or an op that
    writes no argument and returns tensors on its inputs' storages."""
    if func.is_view:
        return True
    if any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments):
        return False
    if not outs:  # it returned its inputs
        return True
    held = {id(t.untyped_storage()) for t in ins}
    return all(id(t.untyped_storage()) in held for t in outs)


__all__ = ["Cost", "CostMode", "tensors_of"]
