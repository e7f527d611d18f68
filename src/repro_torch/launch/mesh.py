"""Mesh construction (the counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is the port's own small object: the axis names ``("data",
"model")``, their sizes, this process's coordinates ``(d, m)``, the device
it computes on, and its groups' collectives
(``parallel/collectives.py:Comm``): ``comm`` the data group (the ranks of
one model coordinate), ``model_comm`` the model group (the ranks of one
data coordinate) and ``world_comm`` every rank.  Ranks are placed as
``jax.make_mesh`` places devices, ``model`` fastest: rank ``d·M + m``.
It is built over the initialized process group (``launch/dist.py`` starts
one); without a group it is the 1×1 mesh of one process, as the JAX
package's is on one device.  The production meshes (16×16, 2×16×16) and
their dry run are a later slice.

The mesh holds its device explicitly: an NCCL group computes on CUDA and a
gloo group on the device its caller names, CUDA unless the caller asks for
the CPU; a mesh asked for CUDA where there is none raises instead of
carrying on on the CPU.
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
    comm: Comm              # the data group
    model_comm: Optional[Comm] = None
    world_comm: Optional[Comm] = None

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.sizes))

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def rank(self) -> int:
        """This process's rank in the world, ``d·M + m``."""
        return self.world_comm.rank if self.world_comm is not None else self.comm.rank

    @property
    def coords(self) -> Tuple[int, int]:
        """(d, m): this rank's data and model coordinates."""
        return divmod(self.rank, self.sizes[1])

    def comm_of(self, group: str) -> Comm:
        """The ``"data"``, ``"model"`` or ``"world"`` group's collectives."""
        return {"data": self.comm, "model": self.model_comm, "world": self.world_comm}[group]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, data {self.comm!r})"


def make_host_mesh(data: Optional[int] = None, model: int = 1, device="cuda") -> Mesh:
    """The (data, model) mesh over the initialized process group, or the 1×1
    mesh of one process without one.  ``data`` defaults to the group's
    size over ``model``; as in the JAX package, a mesh larger than the
    group shrinks to ``(group size, 1)``.  ``device`` is CUDA unless the
    caller asks for the CPU (an error where CUDA is absent); an NCCL
    group computes on its current CUDA device.  Every rank makes every
    group, in the same order: the data groups, then the model groups."""
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    data = max(world // model, 1) if data is None else data
    if data * model > world:
        data, model = world, 1
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh over a group of {world} processes")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    d, m = divmod(rank, model)
    world_comm = Comm(group, dev, rank, world)
    if model == 1:
        return Mesh((data, model), world_comm, Comm(None, dev, 0, 1), world_comm)
    data_groups = [dist.new_group([i * model + j for i in range(data)]) for j in range(model)]
    model_groups = [dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
    return Mesh((data, model), Comm(data_groups[m], dev, d, data),
                Comm(model_groups[d], dev, m, model), world_comm)


def mesh_shape_dict(mesh) -> dict:
    return dict(mesh.shape)


def n_dp_shards(mesh) -> int:
    d = mesh_shape_dict(mesh)
    return d.get("pod", 1) * d.get("data", 1)


__all__ = ["AXES", "Mesh", "make_host_mesh", "mesh_shape_dict", "n_dp_shards"]
