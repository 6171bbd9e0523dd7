"""Device meshes over ``torch.distributed`` and the shard/no-shard gate.

The counterpart of ``kofft_tpu.parallel.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group that the caller started (``torchrun`` or ``init_process_group``),
one rank per device. With no group started, a mesh of one device starts
a world of one rank in this process over a ``FileStore`` in a temporary
directory: NCCL for ``device="cuda"``, gloo for ``"cpu"``. A CUDA mesh
needs NCCL and raises without it; it never falls back to gloo or to the
CPU.

The sharded programs take and return ``DTensor``s, the counterpart of a
``jax.Array`` with a ``NamedSharding``. The helpers here turn an input
into this rank's block (``_local``) and a block back into a ``DTensor``
(``_dtensor``) without communicating, as ``jax.device_put`` of a host
array keeps each device's slice.
"""

from __future__ import annotations

import os
import tempfile
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..config import get_config
from ..errors import InvalidValueError, require
from ..ops._complex import host_float

__all__ = ["make_mesh", "should_shard"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device) -> str:
    kind = torch.device(device).type
    require(kind in _BACKEND, InvalidValueError,
            f"a mesh lies on 'cuda' or 'cpu' devices, got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device, and none is "
                           "available; pass device='cpu' for a gloo mesh")
    return kind


def _world(n_devices: Optional[int], kind: str) -> int:
    """The default group's size, after starting a world of one when no
    group is started and the mesh asks for one device. The group's
    backend must serve ``kind``: NCCL for CUDA, gloo for the CPU."""
    backend = _BACKEND[kind]
    if not dist.is_initialized():
        require(n_devices in (None, 1), InvalidValueError,
                f"a mesh of {n_devices} devices needs a started process "
                f"group of that many ranks (torchrun or "
                f"init_process_group); none is started")
        if kind == "cuda":
            if not dist.is_nccl_available():
                raise RuntimeError("a CUDA mesh needs the NCCL backend, "
                                   "which this torch lacks")
            torch.cuda.set_device(torch.cuda.current_device())
        store = os.path.join(tempfile.mkdtemp(prefix="kofft_store_"),
                             "store")
        dist.init_process_group(backend, store=dist.FileStore(store, 1),
                                rank=0, world_size=1)
    have = dist.get_backend()
    if backend not in have:
        raise RuntimeError(f"a {kind} mesh needs the {backend} backend; the "
                           f"default process group runs {have!r}")
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    """A DeviceMesh of ``shape`` over ranks 0 … prod(shape)-1, row-major."""
    kind = _device_type(device)
    d = int(np.prod(shape))
    world = _world(d, kind)
    require(1 <= d <= world, InvalidValueError,
            f"a mesh of {d} devices needs as many ranks; the world has "
            f"{world}")
    return DeviceMesh(kind, torch.arange(d).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "d",
              device="cuda") -> DeviceMesh:
    """1-D mesh named ``(axis_name,)`` over the first ``n_devices`` ranks
    of the default process group (default: all)."""
    kind = _device_type(device)
    n = n_devices if n_devices is not None else _world(None, kind)
    return _mesh((n,), (axis_name,), kind)


def should_shard(total_points: int, n_devices: int) -> bool:
    """Gate sharded execution on work per rank (``KOFFT_TPU_TORCH_
    SHARD_THRESHOLD`` / ``set_shard_threshold``)."""
    if n_devices <= 1:
        return False
    return total_points // n_devices >= get_config().shard_threshold


# --------------------------------------------------------------------------
# per-rank helpers of the sharded programs
# --------------------------------------------------------------------------

class _Axis(NamedTuple):
    """One mesh dimension as the programs use it: its process group, its
    size, this rank's coordinate along it and its name (the tier that the
    collective log records)."""
    group: object
    size: int
    me: int
    name: str


def _axis(mesh: DeviceMesh, name: str) -> _Axis:
    """The mesh dimension ``name``. ``all_to_all_single`` orders its chunks
    by group rank, and the programs' un-permutes by mesh coordinate: the
    two must agree."""
    names = mesh.mesh_dim_names
    require(names is not None and name in names, InvalidValueError,
            f"the mesh has no dimension {name!r} (it has {names})")
    group = mesh.get_group(name)
    me = mesh.get_local_rank(name)
    if dist.get_rank(group) != me:
        raise RuntimeError(f"group rank {dist.get_rank(group)} differs from "
                           f"mesh coordinate {me} along {name!r}")
    return _Axis(group, mesh.size(names.index(name)), me, name)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _in_mesh(mesh: DeviceMesh) -> tuple:
    coord = mesh.get_coordinate()
    require(coord is not None, InvalidValueError,
            f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return tuple(coord)


def _shape(x) -> tuple:
    """The global shape of a DTensor, tensor or array."""
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _local(x, mesh: DeviceMesh, placements: tuple) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements`` on ``mesh``, float32
    (float64 kept) on the mesh's device. A DTensor on ``mesh`` is
    redistributed to ``placements`` (one on another mesh gathered first);
    a plain tensor or array holds the global value on every rank, and
    each rank keeps its own slice without communicating."""
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements).to_local().contiguous()
        x = x.full_tensor()
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        host_float(np.asarray(x)))
    for size, me, p in zip(mesh.shape, _in_mesh(mesh), placements):
        if isinstance(p, Shard):
            t = t.tensor_split(size, dim=p.dim)[me]
    if t.dtype not in (torch.float32, torch.float64):
        t = t.float()
    return t.to(_mesh_device(mesh)).contiguous()


def _dtensor(local: torch.Tensor, mesh: DeviceMesh,
             placements: tuple) -> DTensor:
    """A DTensor of evenly sharded blocks, built without communicating."""
    shape = list(local.shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            shape[p.dim] *= size
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, placements,
                              shape=torch.Size(shape), stride=tuple(stride))


_NESTED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _nested(mesh: DeviceMesh) -> DeviceMesh:
    """The (chip, slice) view of a (slice, chip) mesh: its transpose, so
    that ``(Shard(a), Shard(a))`` on it orders blocks chip-major, as
    JAX's ``P((chip, slice))``. Every rank builds it at the same point
    (it creates process groups); one view per mesh."""
    view = _NESTED.get(mesh)
    if view is None:
        s_name, c_name = mesh.mesh_dim_names
        view = DeviceMesh(mesh.device_type, mesh.mesh.t().contiguous(),
                          mesh_dim_names=(c_name, s_name))
        _NESTED[mesh] = view
    return view
