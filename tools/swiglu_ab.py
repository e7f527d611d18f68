"""Time kernel #4 (SwiGLU) and the llama-350m train cell from one tree of
this repo, so that two trees can be compared on one card in turns.

    python3 tools/swiglu_ab.py TREE [--train]

TREE is the root of a checkout (this one, or another commit unpacked with
``git archive``).  The script imports that tree's ``chip_smoke.py`` (which
puts the tree's ``src`` first on the path, so its ``repro_torch`` and its
kernels are the ones built and timed) and prints JSON lines tagged with
TREE:

- the forward in the arithmetic every tree has (``swiglu_launch(g, u)``,
  the TPU kernel's) in bf16, cold (L2 flushed) at the main path's shapes
  and warm (back to back) at the decode round's and the expert buffers';
- "in place": the warm time of qwen3-moe's grouped up-product over a
  decode round's expert buffer followed by #4, minus the product alone;
- with ``--train``, the tree's own ``train_phase`` (llama-350m at full
  width and depth: step ms, peak memory and launches a step per mode).

To compare two trees, run it in turns, each in its own process, e.g.
``for t in _parent . . _parent; do python3 tools/swiglu_ab.py $t --train;
done``.  Needs one CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", help="root of the checkout to time")
    ap.add_argument("--train", action="store_true", help="also run the tree's train phase")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs  # the tree's own, which imports the tree's port

    torch = cs.torch
    if not os.path.abspath(cs.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {cs.__file__}, not the tree's chip_smoke.py")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.swiglu import swiglu_launch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def emit(row):
        print(json.dumps({"tree": args.tree, **row}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None})
    cold, warm = cs.ColdTimer(dev), cs.WarmTimer()
    shapes = [(8, 3072), (128 * 8, 768), (128 * 40, 768), (4 * 512, 3072), (8 * 1024, 2736)]
    for rows, f in shapes:
        g, u = randn(rows, f), randn(rows, f)
        row = {"kernel": "swiglu", "shape": [rows, f], "cold_ms": cold(lambda: swiglu_launch(g, u))}
        if rows * f <= 128 * 40 * 768:
            row["warm_ms"] = warm(lambda: swiglu_launch(g, u))
        emit(row)
    E, C, dm, f = 128, 8, 2048, 768
    x, w, u = randn(E, C, dm), randn(E, dm, f), randn(E, C, f)
    both = warm(lambda: swiglu_launch(torch.bmm(x, w), u))
    alone = warm(lambda: torch.bmm(x, w))
    emit({"kernel": "swiglu", "run": "in place", "shape": [E * C, f],
          "product_then_swiglu_ms": both, "product_ms": alone, "in_place_ms": both - alone})
    del x, w, u
    torch.cuda.empty_cache()
    if args.train:
        cs.train_phase(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
