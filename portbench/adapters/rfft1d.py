"""Adapter of the 1-D real FFT configurations (``rfft_split``).

A cell's ``shape`` is the shape of one input signal, the transform running
along its last axis. One input is one float32 signal drawn from the
standard normal distribution (a tensor, not a 1-tuple, so that a step
that returns its input unchanged gives an answer of the wrong shape); the
answer is the pair of one-sided output planes (..., n // 2 + 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import roofline, tf32
from portbench.adapters.stft import make_pool  # noqa: F401
from portbench.check import planes as answer  # noqa: F401
from portbench.reference import rfft1d as reference

UNIT = "points"


def work(cfg: dict, cell: dict) -> dict:
    """Units (real input points) per call and the call's roofline bound."""
    shape = cell["shape"]
    ms, by = roofline.transform_bound(True, math.prod(shape[:-1]),
                                      shape[-1])
    return {"units": math.prod(shape), "bound_s": ms * 1e-3, "bound_by": by}


def entry(cfg: dict, cell: dict):
    """The program's entry as the configuration states it."""
    import kofft_tpu_torch as port
    port.set_precision(cfg["precision"])
    norm, backend = cfg["norm"], cfg["backend"]

    def call(inp):
        return port.rfft_split(inp, norm=norm, backend=backend)
    return call


def expected(cfg: dict, cell: dict, inp) -> np.ndarray:
    """The plain reference's answer to one input."""
    if cfg["norm"] is not None:
        raise ValueError("the reference applies numpy's normalisation")
    return reference.rfft(inp.cpu().numpy())


def control(cfg: dict, cell: dict, inp):
    """The reference's function computed in TF32, in the program's place:
    the first n // 2 + 1 bins of the DFT of (x, 0)."""
    if cfg["norm"] is not None:
        raise ValueError("the control is the unscaled DFT")
    return tf32.dft(inp, torch.zeros_like(inp), inp.shape[-1] // 2 + 1)
