"""Mesh construction (the counterpart of ``repro.launch.mesh``).

A :class:`Mesh` is the port's own small object: the axis names ``("data",
"model")``, or ``("pod", "data", "model")`` with a leading pure
data-parallel ``pod`` axis, their sizes, this process's coordinates, the
device it computes on, and its groups' collectives
(``parallel/collectives.py:Comm``): ``comm`` the data group (the ranks of
one pod and model coordinate), ``model_comm`` the model group (the ranks
of one pod and data coordinate), ``world_comm`` every rank, and under a
``pod`` axis the other groups a step reduces over (:meth:`Mesh.comm_of`,
a group named by the axes its ranks differ along: ``("pod",)``, ``("pod",
"data")``, ``("data", "model")``).  Ranks are placed as ``jax.make_mesh``
places devices, ``model`` fastest: rank ``(p·D + d)·M + m``
(:func:`coord_of`, :func:`rank_of`).  One function, :func:`build_mesh`,
makes the groups of every mesh, real or dry.  :func:`make_host_mesh`
builds a mesh over the initialized process group (``launch/dist.py``
starts one); without a group it is the 1×1 mesh of one process, as the JAX
package's is on one device.

:func:`make_production_mesh` is the JAX package's 16×16 ``(data, model)``
mesh, or 2×16×16 with the ``pod`` axis, over a group of 256 or 512 ranks;
its ``dry`` form (:func:`dry_mesh`) gives this process one rank's
coordinates and a dry ``Comm`` per group at its production size, with no
process group behind it: the dry run's mesh (``launch/dryrun.py``).

The mesh holds its device explicitly: an NCCL group computes on CUDA and a
gloo group on the device its caller names, CUDA unless the caller asks for
the CPU; a mesh asked for CUDA where there is none raises instead of
carrying on on the CPU.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.parallel.collectives import Comm

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
# the groups a mesh with a pod axis makes besides data, model and the world
POD_GROUPS = (("pod",), ("pod", "data"), ("data", "model"))


def coord_of(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` on a mesh of ``shape`` (its axes in
    order), the last axis fastest, as ``jax.make_mesh`` places devices.
    With :func:`rank_of`, the one place that decides where a rank sits."""
    coord = {}
    for a in reversed(list(shape)):
        rank, coord[a] = divmod(rank, shape[a])
    return {a: coord[a] for a in shape}


def rank_of(shape: Dict[str, int], coord: Dict[str, int]) -> int:
    """The rank at ``coord`` on a mesh of ``shape``."""
    r = 0
    for a in shape:
        r = r * shape[a] + coord[a]
    return r


def groups_along(shape: Dict[str, int], axes: Tuple[str, ...]) -> Dict[tuple, List[int]]:
    """The groups of a mesh of ``shape`` along ``axes``: ``{coordinates off
    the axes: [its ranks, the axes in order, the last fastest]}``."""
    off = [a for a in shape if a not in axes]
    along = [a for a in shape if a in axes]
    out = {}
    for fixed in itertools.product(*(range(shape[a]) for a in off)):
        out[fixed] = [rank_of(shape, {**dict(zip(off, fixed)), **dict(zip(along, var))})
                      for var in itertools.product(*(range(shape[a]) for a in along))]
    return out


@dataclass(frozen=True, eq=False)
class Mesh:
    shape: Dict[str, int]  # axis -> size, in the mesh's order
    rank: int              # this process's rank in the world
    comms: Dict[Tuple[str, ...], Comm]  # a group's collectives, by the axes it spans

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def sizes(self) -> Tuple[int, int]:
        """(data, model)."""
        return self.shape["data"], self.shape["model"]

    @property
    def pod(self) -> Optional[int]:
        """The pod axis's size; None on a (data, model) mesh."""
        return self.shape.get("pod")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def comm(self) -> Comm:
        """The data group."""
        return self.comms[("data",)]

    @property
    def model_comm(self) -> Comm:
        return self.comms[("model",)]

    @property
    def world_comm(self) -> Comm:
        return self.comms[self.axis_names]

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def coord(self) -> Dict[str, int]:
        """This rank's coordinate along each axis (pod 0 on a mesh without
        the axis)."""
        return {"pod": 0, **coord_of(self.shape, self.rank)}

    @property
    def coords(self) -> Tuple[int, int]:
        """(d, m): this rank's data and model coordinates (in its pod)."""
        c = self.coord
        return c["data"], c["model"]

    @property
    def pod_coord(self) -> int:
        """p: this rank's pod (0 on a mesh without the axis)."""
        return self.coord["pod"]

    def axes_of(self, group) -> Tuple[str, ...]:
        """The mesh axes of ``group`` (``"data"``, ``"model"``, ``"world"``
        or a tuple of axis names), in the mesh's order, those it lacks left
        out."""
        if isinstance(group, str):
            group = self.axis_names if group == "world" else (group,)
        return tuple(a for a in self.axis_names if a in group)

    def size_of(self, group) -> int:
        """The number of ranks in this rank's ``group``."""
        return math.prod(self.shape[a] for a in self.axes_of(group))

    def index_in(self, group) -> int:
        """This rank's index in its ``group``, its axes in order, the last
        fastest."""
        axes = self.axes_of(group)
        return rank_of({a: self.shape[a] for a in axes}, self.coord)

    def comm_of(self, group) -> Comm:
        """The collectives of this rank's ``group``."""
        axes = self.axes_of(group)
        if axes in self.comms:
            return self.comms[axes]
        if self.size_of(axes) == 1:
            return Comm(None, self.device, 0, 1, axes)
        raise KeyError(f"no group over {axes} on {self!r}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, data {self.comm!r})"


def build_mesh(shape: Dict[str, int], rank: int,
               make: Callable[[Tuple[str, ...], Dict[tuple, List[int]], tuple], Comm]) -> Mesh:
    """The mesh of ``shape`` seen from ``rank``: its data, model and world
    groups and, under a pod axis, those of :data:`POD_GROUPS`, in that
    order.  ``make(axes, groups, key)`` makes one group's ``Comm``:
    ``groups`` every group along ``axes`` (:func:`groups_along`), ``key``
    this rank's."""
    names = tuple(shape)
    want = [("data",), ("model",)] + (list(POD_GROUPS) if "pod" in shape else []) + [names]
    me = coord_of(shape, rank)
    comms = {}
    for axes in dict.fromkeys(want):
        comms[axes] = make(axes, groups_along(shape, axes),
                           tuple(me[a] for a in names if a not in axes))
    return Mesh(dict(shape), rank, comms)


def make_host_mesh(data: Optional[int] = None, model: int = 1, device="cuda",
                   pod: Optional[int] = None) -> Mesh:
    """The (data, model) mesh, or with ``pod`` the (pod, data, model) mesh,
    over the initialized process group, or the 1×1 mesh of one process
    without one.  ``data`` defaults to the group's size over ``pod`` and
    ``model``; as in the JAX package, a mesh without ``pod`` larger than the
    group shrinks to ``(group size, 1)``.  ``device`` is CUDA unless the
    caller asks for the CPU (an error where CUDA is absent); an NCCL group
    computes on its current CUDA device.  A group of the whole world is the
    world's process group, a group of one rank has none, and every rank
    makes each other group, in :func:`build_mesh`'s order."""
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    pods = pod or 1
    data = max(world // (model * pods), 1) if data is None else data
    if pod is None and data * model > world:
        data, model = world, 1
    if pods * data * model != world:
        shape = f"{pods}x{data}x{model}" if pod is not None else f"{data}x{model}"
        raise ValueError(f"a {shape} mesh over a group of {world} processes")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def make(axes, groups, key):
        n = len(groups[key])
        if n == world:
            return Comm(group, dev, rank, world, axes)
        if n == 1:
            return Comm(None, dev, 0, 1, axes)
        made = {k: dist.new_group(r) for k, r in groups.items()}  # every rank makes every group
        return Comm(made[key], dev, groups[key].index(rank), n, axes)

    sizes = (pod, data, model) if pod is not None else (data, model)
    return build_mesh(dict(zip(POD_AXES if pod is not None else AXES, sizes)), rank, make)


def dry_mesh(pod: Optional[int] = None, data: int = 1, model: int = 1, rank: int = 0,
             device="meta") -> Mesh:
    """The mesh of one rank (``rank``, 0 by default) of a (data, model), or
    with ``pod`` a (pod, data, model), mesh, with no process group behind
    it: every group's ``Comm`` is dry (``parallel/collectives.py``), at its
    size on that mesh, on ``device`` (the meta device by default)."""
    shape = {"data": data, "model": model} if pod is None else {"pod": pod, "data": data,
                                                                 "model": model}
    world = math.prod(shape.values())
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a mesh of {world}")
    dev = torch.device(device)
    return build_mesh(shape, rank, lambda axes, groups, key: Comm(
        None, dev, groups[key].index(rank), len(groups[key]), axes, dry=True))


PRODUCTION = {False: (None, 16, 16), True: (2, 16, 16)}


def make_production_mesh(multi_pod: bool = False, *, dry: bool = False, device="cuda",
                         rank: int = 0) -> Mesh:
    """The JAX package's production mesh: 16×16 ``(data, model)``, or with
    ``multi_pod`` 2×16×16 with a leading pure data-parallel ``pod`` axis.
    Over the initialized process group of 256 or 512 ranks (raises where
    that group does not exist); ``dry`` gives rank ``rank``'s mesh without
    one (:func:`dry_mesh`, on the meta device unless ``device`` says
    otherwise)."""
    pod, data, model = PRODUCTION[multi_pod]
    if dry:
        return dry_mesh(pod, data, model, rank, "meta" if device == "cuda" else device)
    import torch.distributed as dist

    want = (pod or 1) * data * model
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(f"the production mesh needs a process group of {want} ranks, "
                           f"this process has {'none' if not have else have}; pass dry=True "
                           "for its dry run")
    return make_host_mesh(data, model, device=device, pod=pod)


def mesh_shape_dict(mesh) -> dict:
    return dict(mesh.shape)


def n_dp_shards(mesh) -> int:
    d = mesh_shape_dict(mesh)
    return d.get("pod", 1) * d.get("data", 1)


__all__ = ["AXES", "POD_AXES", "Mesh", "build_mesh", "coord_of", "dry_mesh", "groups_along",
           "make_host_mesh", "make_production_mesh", "mesh_shape_dict", "n_dp_shards", "rank_of"]
