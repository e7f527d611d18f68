"""Mesh construction (the counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is the port's own small object: the axis names ``("data",
"model")``, their sizes, the device this process computes on, and the data
group's collectives (``parallel/collectives.py:Comm``).  It is built over
the initialized process group (``launch/dist.py`` starts one); without a
group it is the 1×1 mesh of one process, as the JAX package's is on one
device.  The port runs the ``model`` axis at 1: TP, EP and SP, and the
production meshes (16×16, 2×16×16) with their dry run, are later slices.

The mesh holds its device explicitly: an NCCL group computes on CUDA and a
gloo group on the device its caller names; a mesh asked for CUDA where
there is none raises instead of carrying on on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.parallel.collectives import Comm

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    sizes: Tuple[int, int]  # (data, model)
    comm: Comm

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.sizes))

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def rank(self) -> int:
        return self.comm.rank

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.comm!r})"


def make_host_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over the initialized process group, or the 1×1
    mesh of one process without one.  ``data`` defaults to the group's
    size; as in the JAX package, a mesh larger than the group shrinks to
    ``(group size, 1)``.  ``device`` defaults to the current CUDA device of
    an NCCL group, else the CPU (a gloo group computes on CUDA only where
    the caller names it)."""
    import torch.distributed as dist

    if model > 1:
        raise NotImplementedError("a 'model' axis above 1 runs in a later slice of the port")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    data = world if data is None else data
    if data * model > world:
        data, model = world, 1
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh over a group of {world} processes")
    if device is None:
        if group is not None and dist.get_backend(group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = "cpu"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((data, model), Comm(group, dev, rank, world))


def mesh_shape_dict(mesh) -> dict:
    return dict(mesh.shape)


def n_dp_shards(mesh) -> int:
    d = mesh_shape_dict(mesh)
    return d.get("pod", 1) * d.get("data", 1)


__all__ = ["AXES", "Mesh", "make_host_mesh", "mesh_shape_dict", "n_dp_shards"]
