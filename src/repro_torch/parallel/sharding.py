"""Logical-axis sharding rules (the counterpart of
``repro.parallel.sharding``).

Every parameter carries *logical* axis names (``models/params.py:
param_annotations``); :class:`ShardingRules` maps them to the mesh axes
``data`` (data parallelism and FSDP) and ``model`` (TP / EP / SP).  A spec
is the port's :class:`Spec`, a tuple with one entry per dim: ``None``, a
mesh axis name, or a tuple of them.

``constrain`` is the identity: eager PyTorch has no layout constraint; the
port's step moves shards itself (``launch/steps.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

Tree = Any


class Spec(tuple):
    """One entry per dim: None, a mesh axis name, or a tuple of names (a
    one-name tuple is its name, as in a JAX ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim ``axis`` shards, or None."""
        for i, e in enumerate(self):
            if e == axis or (isinstance(e, tuple) and axis in e):
                return i
        return None


# Logical axis vocabulary, as in the JAX package: batch, seq, embed,
# heads, kv_heads, mlp, vocab, expert, cache_seq, ssm_inner, norm, stacked.


@dataclass(frozen=True)
class ShardingRules:
    batch: Tuple[str, ...] = ("pod", "data")
    seq: Optional[str] = None
    embed: object = "data"
    embed_tbl: Optional[str] = "data"
    heads: Optional[str] = "model"
    kv_heads: Optional[str] = "model"
    kv_cache: Optional[str] = "model"
    cache_hd: Optional[str] = None
    mlp: Optional[str] = "model"
    vocab: Optional[str] = "model"
    expert: Optional[str] = "model"
    expert_embed: Optional[str] = "data"
    dispatch: Tuple[str, ...] = ("pod", "data")
    cache_seq: Optional[str] = None
    ssm_inner: Optional[str] = "model"
    norm: Optional[str] = None
    stacked: Optional[str] = None

    def spec(self, *logical: Optional[str]) -> Spec:
        """The spec of a tensor whose dims carry these logical names.  A mesh
        axis shards only one dim: where two names resolve to the same axis,
        the later dim stays unsharded."""
        out = []
        used = set()
        for name in logical:
            if name is None:
                out.append(None)
                continue
            ax = getattr(self, name)
            members = set(ax) if isinstance(ax, tuple) else ({ax} if ax else set())
            if members & used:
                out.append(None)
                continue
            used |= members
            out.append(ax)
        return Spec(*out)


def default_rules(mesh, *, fsdp: bool = True, sequence_parallel: bool = False,
                  n_kv_heads: int = 0) -> ShardingRules:
    """Rules adapted to the mesh (anything with ``axis_names`` and a
    ``shape`` mapping) and model at hand."""
    axes = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in axes)
    rules = ShardingRules(batch=batch, dispatch=batch)
    if "model" not in axes:
        rules = replace(rules, heads=None, kv_heads=None, kv_cache=None, mlp=None,
                        vocab=None, expert=None, ssm_inner=None)
    if not fsdp or "data" not in axes:
        rules = replace(rules, embed=None, embed_tbl=None, expert_embed=None)
    if sequence_parallel and "model" in axes:
        rules = replace(rules, seq="model")
    # GQA decode caches: a KV-head count the model axis does not divide
    # shards the cache over head_dim instead
    if n_kv_heads and "model" in axes:
        if n_kv_heads % mesh.shape["model"] != 0:
            rules = replace(rules, kv_cache=None, cache_hd="model")
    return rules


def logical_to_spec(rules: ShardingRules, logical: Tuple[Optional[str], ...]) -> Spec:
    return rules.spec(*logical)


def is_annotation(a) -> bool:
    """A leaf annotation: a tuple of logical-axis names (str or None)."""
    return (isinstance(a, tuple) and not isinstance(a, Spec) and len(a) > 0
            and all(x is None or isinstance(x, str) for x in a))


def map_tree(fn, tree: Tree, is_leaf) -> Tree:
    """``fn`` over the leaves of a tree of dicts, tuples and NamedTuples,
    where ``is_leaf`` says what a leaf is."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, is_leaf) for v in tree)
    return fn(tree)


def spec_leaves(tree: Tree) -> list:
    """The specs of a spec tree in the params' leaf order (dict keys
    sorted, as ``models/params.py:tree_leaves``)."""
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in spec_leaves(t)]
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def spec_tree(rules: ShardingRules, ann_tree: Tree) -> Tree:
    """A tree of logical annotations as a tree of specs."""
    return map_tree(lambda ann: rules.spec(*ann), ann_tree, is_annotation)


def cache_spec(ann, bax, rules: ShardingRules) -> Spec:
    """The spec of a cache leaf annotated ``ann`` (``models/kvcache.py``)
    with its batch dim over ``bax``: the JAX package's ``_cache_spec``, each
    name read from the rules as it is (no axis deduplication)."""
    out = []
    for name in ann:
        if name == "batch":
            out.append(bax)
        elif name is None or name == "stacked":
            out.append(None)
        else:
            out.append(getattr(rules, name))
    return Spec(*out)


def held_cache_spec(ann, bax, rules: ShardingRules, kv_cut: bool,
                    ssm_cut: bool = False) -> Spec:
    """The spec of the cache leaf a rank of the port holds: :func:`cache_spec`
    but for the heads.  The KV-head dim is cut over ``model`` only where the
    layers cut the KV heads (``kv_cut``); the head dim is never cut: where
    the rules cut it (``cache_hd``, a KV head count the axis does not
    divide) a rank holds ``local_kv``'s whole heads instead
    (``models/kvcache.py:held_kv_heads``), which no spec over the mesh
    describes.  The SSM caches' ``heads`` and ``ssm_inner`` dims are cut
    only where the layers cut the mixer (``ssm_cut``); the conv window's
    cut is then segmented (its heads' channels, B and C whole), which
    ``"model"`` stands for."""
    spec = list(cache_spec(ann, bax, rules))
    for i, name in enumerate(ann):
        if name == "cache_hd" or (name == "kv_cache" and not kv_cut):
            spec[i] = None
        elif name in ("heads", "ssm_inner"):
            spec[i] = "model" if ssm_cut else None
    return Spec(*spec)


def constrain(x, rules: ShardingRules, *logical: Optional[str]):
    """The identity: eager PyTorch has no layout constraint to set."""
    return x


def batch_spec(rules: ShardingRules) -> Spec:
    return Spec(rules.batch if rules.batch else None)


def param_specs(params, annotations):
    """The JAX package's identity over a spec tree."""
    return map_tree(lambda ann: ann, annotations, lambda a: isinstance(a, Spec))


def state_specs(param_spec_tree):
    """Optimizer states share the param sharding."""
    return param_spec_tree


__all__ = ["ShardingRules", "Spec", "batch_spec", "cache_spec", "constrain", "default_rules",
           "held_cache_spec",
           "is_annotation", "logical_to_spec", "map_tree", "param_specs", "spec_leaves",
           "spec_tree", "state_specs"]
