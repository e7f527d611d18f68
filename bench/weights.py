"""Seeded weights of one pipeline stage, made on the device.

Every leaf is a function of (seed, its path) alone, so a leaf can be made
again after the window (the reference's copy, the parameters' change) and
comes out bit for bit the same.  A leaf is made in its served dtype with
one ``torch.randn`` call from a generator on the device, then scaled:

- ``embed``: N(0, 0.02^2); the norm scales: ones;
- every other matrix: N(0, 1/fan_in), fan_in its second-last dim;
- the FFN and expert matrices (``w_up``, ``w_gate``, ``w_down``) also
  carry a planted component of MeCeFO's rank r: ``W = G + s A B^T``
  with A (n, r) and B (m, r) orthonormal columns drawn from the seed and
  ``s = PLANT_SCALE * (1 + sqrt(m / n))``, twice the edge of G's singular
  values.  At plain Gaussian weights the
  top-64 singular values lie ~1e-3 of their size apart, so the rounding
  to bf16 tilts MeCeFO's V1 subspace; the planted gap makes V1 a property
  of the weights rather than of their last bits, as a trained model's
  decaying spectrum does.

Imports nothing of the program: the reference takes its weights from here.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

PLANT_SCALE = 2.0
PLANTED = ("w_up", "w_gate", "w_down")
NORMS = ("ln", "final_norm", "q_norm", "k_norm")
# f32 elements of one chunk of planted sums (1 GiB)
CHUNK_ELEMS = 1 << 28


def leaf_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every leaf of a stage, in the program's tree order
    (dict keys sorted): ``m`` holds the sizes (``model_sizes``)."""
    d, L, V = m["d"], m["layers"], m["vocab"]
    H, KV, hd = m["heads"], m["kv_heads"], m["head_dim"]
    mixer = {"ln": (L, d), "wq": (L, d, H * hd), "wk": (L, d, KV * hd),
             "wv": (L, d, KV * hd), "wo": (L, H * hd, d)}
    if m["qk_norm"]:
        mixer.update(q_norm=(L, hd), k_norm=(L, hd))
    if m.get("moe"):
        E, f = m["moe"]["experts"], m["moe"]["d_ff"]
        ffn = {"ln": (L, d), "router": (L, d, E), "w_up": (L, E, d, f),
               "w_gate": (L, E, d, f), "w_down": (L, E, f, d)}
    else:
        f = m["d_ff"]
        ffn = {"ln": (L, d), "w_up": (L, d, f), "w_gate": (L, d, f), "w_down": (L, f, d)}
    out = [("embed", (V, d)), ("final_norm", (d,))]
    out += [(f"layers.0.ffn.{k}", ffn[k]) for k in sorted(ffn)]
    out += [(f"layers.0.mixer.{k}", mixer[k]) for k in sorted(mixer)]
    out += [("unembed", (d, V))]
    return sorted(out)


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit generator seed for one leaf of one run."""
    h = hashlib.sha256(f"{int(seed)}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(path: str, shape, seed: int, device, dtype=torch.bfloat16,
              rank: int = 64, f32: bool = False) -> torch.Tensor:
    """Leaf ``path`` of the run with ``seed``, in ``dtype``, planted at
    ``rank`` (or, with ``f32``, the planted sum before its one rounding:
    the weights as they were meant, for the V1 check)."""
    name = path.rsplit(".", 1)[-1]
    if name in NORMS:
        return torch.ones(shape, dtype=torch.float32 if f32 else dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path))
    std = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)
    if name not in PLANTED:
        return w.float() if f32 else w
    n, m = shape[-2], shape[-1]
    r = min(rank, n, m)
    s = PLANT_SCALE * (1.0 + math.sqrt(m / n))
    lead = shape[:-2]
    flat = w.view(-1, n, m)
    out = torch.empty(flat.shape, dtype=torch.float32, device=device) if f32 else flat
    step = max(1, CHUNK_ELEMS // (n * m))
    for i in range(0, flat.shape[0], step):  # a chunk of matrices' f32 sums at a time
        j = min(i + step, flat.shape[0])
        a = torch.linalg.qr(torch.randn((j - i, n, r), generator=g, device=device)).Q
        b = torch.linalg.qr(torch.randn((j - i, m, r), generator=g, device=device)).Q
        out[i:j] = torch.baddbmm(flat[i:j].float(), a, b.transpose(1, 2), alpha=s).to(out.dtype)
    return out.view(*lead, n, m)


def make_all(m: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every leaf of the stage, by path."""
    return {p: make_leaf(p, s, seed, device, dtype, m["rank"]) for p, s in leaf_specs(m)}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The program's nested tree ({"layers": ({"mixer": .., "ffn": ..},)})
    from leaves by path."""
    tree: Dict = {}
    for path, t in flat.items():
        parts = path.split(".")
        if parts[0] == "layers":
            layers = tree.setdefault("layers", {})
            layers.setdefault(int(parts[1]), {}).setdefault(parts[2], {})[parts[3]] = t
        else:
            tree[parts[0]] = t
    if "layers" in tree:
        tree["layers"] = tuple(tree["layers"][i] for i in sorted(tree["layers"]))
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves by path of a nested tree of dicts and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):  # a shape is a leaf
        out = {}
        for i, t in enumerate(tree):
            out.update(flatten(t, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def change_norms(store: Dict[str, torch.Tensor], m: Dict, seed: int, device) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's initial weights, f32,
    in blocks of rows (the initial leaf made again)."""
    out = {}
    for p, w in store.items():
        w0 = make_leaf(p, tuple(w.shape), seed, device, w.dtype, m["rank"])
        sq = 0.0
        rows, rows0 = w.reshape(-1, w.shape[-1]), w0.reshape(-1, w.shape[-1])
        for a, b in zip(rows.split(1 << 14), rows0.split(1 << 14)):
            sq += float((a.float() - b.float()).double().square().sum())
        out[p] = math.sqrt(sq)
        del w0
    return out
