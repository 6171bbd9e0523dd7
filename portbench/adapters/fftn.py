"""Adapter of the 2-D complex FFT configurations (``fftn_split`` over the
last two axes).

A cell's ``shape`` is the shape of one input plane, the transform running
over its last two axes (leading dims are a batch). One input is a pair of
float32 planes drawn from the standard normal distribution, as for the
1-D FFT (``fft1d.make_pool``); the answer is the pair of output planes.
"""

from __future__ import annotations

import math

import numpy as np

from portbench import roofline, tf32
from portbench.adapters.fft1d import make_pool  # noqa: F401
from portbench.check import planes as answer  # noqa: F401
from portbench.reference import fftn2d as reference

UNIT = "points"


def _axes(cfg: dict, cell: dict) -> tuple:
    """The configuration's axes as non-negative indices of the shape;
    this adapter serves the last two."""
    nd = len(cell["shape"])
    axes = tuple(a % nd for a in cfg["axes"])
    if axes != (nd - 2, nd - 1):
        raise ValueError("this adapter runs the 2-D FFT of the last two axes")
    return axes


def work(cfg: dict, cell: dict) -> dict:
    """Units (complex points) per call and the call's roofline bound."""
    shape = cell["shape"]
    ms, by = roofline.nd_bound(shape, _axes(cfg, cell))
    return {"units": math.prod(shape), "bound_s": ms * 1e-3, "bound_by": by}


def entry(cfg: dict, cell: dict):
    """The program's entry as the configuration states it."""
    import kofft_tpu_torch as port
    port.set_precision(cfg["precision"])
    axes, inverse, backend = _axes(cfg, cell), cfg["inverse"], cfg["backend"]

    def call(inp):
        return port.fftn_split(inp[0], inp[1], axes=axes, inverse=inverse,
                               backend=backend)
    return call


def expected(cfg: dict, cell: dict, inp) -> np.ndarray:
    """The plain reference's answer to one input."""
    return reference.fft2(inp[0].cpu().numpy(), inp[1].cpu().numpy(),
                          cfg["inverse"])


def control(cfg: dict, cell: dict, inp):
    """The reference's function computed in TF32, in the program's place:
    the DFT along the last axis, then along axis -2 through a transpose."""
    if cfg["inverse"]:
        raise ValueError("the control is the forward DFT")
    yr, yi = tf32.dft(inp[0], inp[1])
    yr, yi = tf32.dft(yr.transpose(-1, -2), yi.transpose(-1, -2))
    return yr.transpose(-1, -2), yi.transpose(-1, -2)
