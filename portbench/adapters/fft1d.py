"""Adapter of the 1-D complex FFT configurations (``fft_split``).

A cell's ``shape`` is the shape of one input plane, the transform running
along its last axis. One input is a pair of float32 planes drawn from the
standard normal distribution; the answer is the pair of output planes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline, tf32
from portbench.check import planes as answer  # noqa: F401
from portbench.reference import fft1d as reference

UNIT = "points"


def work(cfg: dict, cell: dict) -> dict:
    """Units (complex points) per call and the call's roofline bound."""
    shape = cell["shape"]
    ms, by = roofline.transform_bound(False, math.prod(shape[:-1]),
                                      shape[-1])
    return {"units": math.prod(shape), "bound_s": ms * 1e-3, "bound_by": by}


def make_pool(cfg: dict, cell: dict, seed: int, device) -> list:
    """``cell["pool"]`` distinct input pairs, drawn on ``device`` by one
    generator call from ``seed``: the same seed gives the same pool."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    data = torch.randn((cell["pool"], 2, *cell["shape"]), generator=g,
                       device=device, dtype=torch.float32)
    return [(data[j, 0], data[j, 1]) for j in range(cell["pool"])]


def entry(cfg: dict, cell: dict):
    """The program's entry as the configuration states it."""
    import kofft_tpu_torch as port
    port.set_precision(cfg["precision"])
    inverse, norm, backend = cfg["inverse"], cfg["norm"], cfg["backend"]

    def call(inp):
        return port.fft_split(inp[0], inp[1], inverse=inverse, norm=norm,
                              backend=backend)
    return call


def expected(cfg: dict, cell: dict, inp) -> np.ndarray:
    """The plain reference's answer to one input."""
    if cfg["norm"] is not None:
        raise ValueError("the reference applies numpy's normalisation")
    return reference.fft(inp[0].cpu().numpy(), inp[1].cpu().numpy(),
                         cfg["inverse"])


def control(cfg: dict, cell: dict, inp):
    """The reference's function computed in TF32, in the program's place."""
    if cfg["inverse"] or cfg["norm"] is not None:
        raise ValueError("the control is the forward, unscaled DFT")
    return tf32.dft(inp[0], inp[1])
