"""Adapter of the trial cell on more than one card: the port's
slab-sharded N-D FFT (``kofft_tpu_torch.parallel.fftn_sharded``) over
every axis of a complex cube, one rank per card.

A cell's ``shape`` is the cube's. Each rank draws the whole pool from the
seed by one generator call, the same on every rank, and keeps its slab of
axis 0, the layout the program takes; the answer is the rank's block of
the output planes, which the program leaves sharded on the last axis, and
``expected`` the same block of NumPy's float64 ``fftn`` of the whole
input, which it gathers from the slabs (a collective: every rank checks
the same sampled calls in the same order). That holds the whole reference
on every rank, which the trial's small cubes allow; a cell at 1024^3 needs
an ``expected`` that works out the rank's block alone. The work per call
is the whole cube's, its bound the d cards' together.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline
from portbench.check import planes

UNIT = "points"


def _mesh():
    import torch.distributed as dist
    from kofft_tpu_torch.parallel import make_mesh
    return make_mesh(device="cuda" if dist.get_backend() == "nccl"
                     else "cpu")


def work(cfg: dict, cell: dict) -> dict:
    import torch.distributed as dist
    shape = cell["shape"]
    ms, by = roofline.nd_bound(shape)
    return {"units": math.prod(shape),
            "bound_s": ms * 1e-3 / dist.get_world_size(), "bound_by": by}


def make_pool(cfg: dict, cell: dict, seed: int, device) -> list:
    from torch.distributed.tensor import DTensor, Shard
    mesh = _mesh()
    d, r = mesh.size(), mesh.get_local_rank()
    shape = cell["shape"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    data = torch.randn((cell["pool"], 2, *shape), generator=g,
                       device=device, dtype=torch.float32)
    s = shape[0] // d
    slabs = data[:, :, r * s:(r + 1) * s].clone()
    del data
    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))

    def dt(t):
        return DTensor.from_local(t, mesh, (Shard(0),),
                                  shape=torch.Size(shape), stride=stride)
    return [(dt(slabs[j, 0]), dt(slabs[j, 1])) for j in range(cell["pool"])]


def entry(cfg: dict, cell: dict):
    import kofft_tpu_torch as port
    from kofft_tpu_torch.parallel import fftn_sharded
    port.set_precision(cfg["precision"])
    mesh = _mesh()
    kw = {k: cfg[k] for k in ("inverse", "backend", "restore_layout",
                              "overlap")}

    def call(inp):
        return fftn_sharded(inp[0], inp[1], mesh=mesh, **kw)
    return call


def answer(out) -> np.ndarray:
    return planes((out[0].to_local(), out[1].to_local()))


def expected(cfg: dict, cell: dict, inp) -> np.ndarray:
    import torch.distributed as dist
    xr, xi = (t.full_tensor().double().cpu().numpy() for t in inp)
    y = (np.fft.ifftn if cfg["inverse"] else np.fft.fftn)(xr + 1j * xi)
    d, r = dist.get_world_size(), dist.get_rank()
    if cfg["restore_layout"]:
        return np.array_split(y, d, axis=0)[r]
    return np.array_split(y, d, axis=-1)[r]
