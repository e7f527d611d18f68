"""Starting the data group: from ``torchrun``'s environment, from explicit
arguments, or by spawning W ranks in this machine (the tests and
``chip_smoke.py``).

``torchrun --nproc-per-node W -m repro_torch.launch.train ...`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`init_from_env` reads them, sets the rank's CUDA
device before an NCCL group starts, and returns the mesh.  :func:`spawn`
runs a function on W fresh processes whose group starts from a ``file://``
in a temporary directory (so concurrent test workers never share a port),
with one intra-op thread per CPU rank (torch's default threads spin
against each other beside other workers).  A rank's exception, a rank
that exits non-zero or a spawn past its timeout raises in the caller.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import Mesh, make_host_mesh


def init_process_group(rank: int, world: int, *, init_method: str, backend: Optional[str] = None,
                       device="cpu") -> Mesh:
    """Start this process's group and return the (world, 1) mesh.
    ``backend`` defaults to NCCL for a CUDA device and gloo otherwise; gloo
    with a CUDA device is the caller's choice (two ranks on one card)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)  # before an NCCL group starts
        dev = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return make_host_mesh(device=dev)


def init_from_env(device="cuda", backend: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of a ``torchrun`` rank, or None outside ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return init_process_group(rank, world, init_method="env://", backend=backend, device=dev)


def destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world, init_method, backend, device, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = init_process_group(rank, world, init_method=init_method, backend=backend,
                              device=device)
    try:
        fn(mesh, *args)
    finally:
        destroy()


def spawn(fn, world: int, *args, backend: Optional[str] = None, device="cpu",
          timeout: float = 600.0) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` fresh processes (``fn`` at module
    level, so the ranks can import it).  Raises a rank's exception, or
    ``TimeoutError`` (after ending every rank) past ``timeout`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init_method, backend, str(device), args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()


__all__ = ["destroy", "init_from_env", "init_process_group", "spawn"]
