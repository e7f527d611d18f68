"""Starting the process group and its mesh: from ``torchrun``'s
environment, from explicit arguments, or by spawning W ranks in this
machine (the tests and ``chip_smoke.py``).

``torchrun --nproc-per-node W -m repro_torch.launch.train ...`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`init_from_env` reads them, sets the rank's CUDA
device before an NCCL group starts, and returns the mesh (``model`` ranks
a data coordinate, 1 by default).  :func:`spawn` runs a function on W
fresh processes whose group starts from a ``file://`` in a temporary
directory (so concurrent test workers never share a port), with one
intra-op thread per CPU rank (torch's default threads spin against each
other beside other workers).  A rank's exception, a rank that exits
non-zero or a spawn past its timeout raises in the caller.  Where several
ranks fail (a peer's teardown error follows the rank that failed first),
the caller gets the exception the earliest failing rank raised, with the
others' attached as notes.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import Mesh, make_host_mesh


def init_process_group(rank: int, world: int, *, init_method: str, backend: Optional[str] = None,
                       device="cuda", model: int = 1) -> Mesh:
    """Start this process's group and return the (world / model, model)
    mesh.  ``device`` is CUDA unless the caller asks for the CPU (an error
    where CUDA is absent, as every entry point of the port).  ``backend``
    defaults to NCCL for a CUDA device and gloo otherwise; gloo with a CUDA
    device is the caller's choice (ranks sharing one card)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)  # before an NCCL group starts
        dev = torch.device("cuda", index)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return make_host_mesh(world // model, model, device=dev)


def init_from_env(device="cuda", backend: Optional[str] = None, model: int = 1) -> Optional[Mesh]:
    """The mesh of a ``torchrun`` rank, or None outside ``torchrun``."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return init_process_group(rank, world, init_method="env://", backend=backend, device=dev,
                              model=model)


def destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _record(errors: str, rank: int, exc: BaseException) -> None:
    """Write a failing rank's exception with the time it was raised (the
    system-wide monotonic clock), atomically."""
    try:
        payload = pickle.dumps(exc)
        pickle.loads(payload)
    except Exception:  # an exception that does not survive pickling
        payload = None
    rec = {"t": time.monotonic(), "rank": rank, "exc": payload,
           "text": "".join(traceback.format_exception(exc))}
    path = os.path.join(errors, f"rank{rank}")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(rec, f)
    os.replace(path + ".tmp", path)


def _rank_main(rank, fn, world, init_method, backend, device, model, errors, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        mesh = init_process_group(rank, world, init_method=init_method, backend=backend,
                                  device=device, model=model)
        try:
            fn(mesh, *args)
        finally:
            destroy()
    except BaseException as e:  # recorded before the teardown can fail in a peer
        _record(errors, rank, e)
        raise


def _first_failure(errors: str) -> Optional[BaseException]:
    """The exception of the rank that failed first, the others' attached."""
    recs = []
    for name in os.listdir(errors):
        if name.startswith("rank") and not name.endswith(".tmp"):
            with open(os.path.join(errors, name), "rb") as f:
                recs.append(pickle.load(f))
    if not recs:
        return None
    recs.sort(key=lambda r: r["t"])
    first = recs[0]
    exc = pickle.loads(first["exc"]) if first["exc"] is not None else \
        RuntimeError(f"rank {first['rank']} failed:\n{first['text']}")
    exc.add_note(f"raised in rank {first['rank']}:\n{first['text']}")
    for r in recs[1:]:
        exc.add_note(f"rank {r['rank']} failed after it:\n{r['text']}")
    return exc


def spawn(fn, world: int, *args, backend: Optional[str] = None, device="cuda",
          timeout: float = 600.0, model: int = 1) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` fresh processes (``fn`` at module
    level, so the ranks can import it) over a ``(world / model, model)``
    mesh on ``device`` (CUDA unless the caller asks for the CPU; checked
    here, before any rank starts).  Raises the exception of the rank that
    failed first, or ``TimeoutError`` (after ending every rank) past
    ``timeout`` seconds."""
    import torch.multiprocessing as mp

    resolve_device(device)

    if world % model:
        raise ValueError(f"{world} ranks do not make a mesh with a model axis of {model}")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        errors = os.path.join(tmp, "errors")
        os.makedirs(errors)
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init_method, backend, str(device), model, errors, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = _first_failure(errors)
            if first is None:
                raise
            raise first from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()


__all__ = ["destroy", "init_from_env", "init_process_group", "spawn"]
