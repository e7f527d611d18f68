"""State-tree helpers shared by checkpointing and state transfer (the
counterpart of ``repro.utils.trees``).

A state tree is nested dicts (children in sorted key order, as JAX orders
them), tuples, lists and NamedTuples (``TrainState``, ``AdamWState``) over
leaves: tensors, numpy arrays and plain Python scalars.  The port's step
updates params and moments **in place** (``optim/optimizers.py``), so a
copy that must outlive the next step has to be a real copy:
:func:`host_copy` never aliases a leaf, not even a tensor that already lies
on the CPU (where ``t.cpu()`` returns ``t`` itself).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Tree = Any


def _node(x):
    """``(children, rebuild)`` of an inner node, or None for a leaf."""
    if isinstance(x, dict):
        keys = sorted(x)

        def rebuild(children):
            got = dict(zip(keys, children))
            return {k: got[k] for k in x}  # the original key order

        return [x[k] for k in keys], rebuild
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(x), lambda ch: type(x)(*ch)
    if isinstance(x, (tuple, list)):
        return list(x), lambda ch: type(x)(ch)
    return None


def tree_flatten(tree: Tree) -> Tuple[List[Any], Callable[[List[Any]], Tree]]:
    """The leaves of ``tree`` and a function that builds a tree of the same
    structure (dict key order included) from a list of new leaves."""
    leaves: List[Any] = []

    def walk(x):
        node = _node(x)
        if node is None:
            leaves.append(x)
            return lambda it: next(it)
        children, rebuild = node
        subs = [walk(c) for c in children]
        return lambda it: rebuild([s(it) for s in subs])

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_nbytes(tree: Tree) -> int:
    """Total payload bytes of a tree, measured from the real leaves."""
    def nbytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return np.asarray(x).nbytes

    return sum(nbytes(x) for x in tree_flatten(tree)[0])


# the JAX package's ``TrainState.step`` is an int32 device scalar; the
# port's is a host int (8 bytes under ``tree_nbytes``, as numpy measures it)
STEP_NBYTES = 4


def state_nbytes(tree: Tree) -> int:
    """Payload bytes of a state tree as the JAX package measures the same
    state: :func:`tree_nbytes`, except that a NamedTuple's host-int
    ``step`` field (the port's ``TrainState.step``) counts as the int32
    scalar it stands for.  The measure of state transfer: the controller's
    ``state_nbytes``, every snapshot's ``nbytes`` and every receipt's
    ``bytes_moved``.  Any other tree, a plain int leaf included, measures
    as :func:`tree_nbytes` does."""
    fields = getattr(tree, "_fields", ())
    if isinstance(tree, tuple) and "step" in fields and is_py_scalar(tree.step):
        return STEP_NBYTES + sum(tree_nbytes(getattr(tree, f)) for f in fields if f != "step")
    return tree_nbytes(tree)


def is_py_scalar(x: Any) -> bool:
    """A plain Python scalar leaf (no ``dtype``): preserved as-is by copies
    so save/restore round trips keep the exact leaf types."""
    return isinstance(x, (bool, int, float, complex)) and not hasattr(x, "dtype")


def host_copy(tree: Tree) -> Tree:
    """Device-to-host copy of a state tree: tensors become CPU tensors
    that share no memory with the originals, numpy arrays are copied, and
    plain Python scalars (immutable) pass through unchanged."""
    def leaf(x):
        if is_py_scalar(x):
            return x
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return np.array(x, copy=True)

    leaves, unflatten = tree_flatten(tree)
    return unflatten([leaf(x) for x in leaves])


__all__ = ["host_copy", "is_py_scalar", "state_nbytes", "tree_flatten", "tree_nbytes"]
