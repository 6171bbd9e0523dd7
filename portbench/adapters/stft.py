"""Adapter of the one-sided STFT configurations (``stft_split``).

A cell's ``shape`` is the shape of one input signal (the last axis is
time), ``win`` the length of its periodic Hann window and ``hop`` the
hop. One input is a float32 signal drawn from the standard normal
distribution; the answer is the pair of one-sided spectra planes
(..., F, win // 2 + 1), F = ceil(N / hop).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import roofline, tf32
from portbench.reference import stft as reference

UNIT = "frames"


def _frames(cell: dict) -> int:
    shape = cell["shape"]
    return math.prod(shape[:-1]) * -(-shape[-1] // cell["hop"])


def work(cfg: dict, cell: dict) -> dict:
    """Units (frames) per call and the call's roofline bound."""
    shape = cell["shape"]
    ms, by = roofline.stft_bound(math.prod(shape[:-1]), shape[-1],
                                 cell["win"], cell["hop"])
    return {"units": _frames(cell), "bound_s": ms * 1e-3, "bound_by": by}


def make_pool(cfg: dict, cell: dict, seed: int, device) -> list:
    """``cell["pool"]`` distinct signals, drawn on ``device`` by one
    generator call from ``seed``: the same seed gives the same pool."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    data = torch.randn((cell["pool"], *cell["shape"]), generator=g,
                       device=device, dtype=torch.float32)
    return [data[j] for j in range(cell["pool"])]


def entry(cfg: dict, cell: dict):
    """The program's entry as the configuration states it: the window is
    the program's own ``window.hann``, as its users call it."""
    import kofft_tpu_torch as port
    if cfg["window"] != "hann" or not cfg["onesided"]:
        raise ValueError("this adapter runs the one-sided hann STFT")
    port.set_precision(cfg["precision"])
    w = port.window.hann(cell["win"])
    hop, backend = cell["hop"], cfg["backend"]

    def call(inp):
        return port.stft_split(inp, w, hop, onesided=True, backend=backend)
    return call


def answer(out) -> np.ndarray:
    """The program's pair of planes as complex128 on the host: joined on
    their own device, so one copy crosses to the host and the host does no
    arithmetic on them (the same values as ``check.planes``)."""
    return torch.complex(out[0].double(), out[1].double()).cpu().numpy()


def expected(cfg: dict, cell: dict, inp) -> np.ndarray:
    """The plain reference's answer to one input, signal by signal, the
    signals shared among up to 8 threads (NumPy's FFT runs without the
    interpreter's lock), so that a run's check stays shorter than its
    window."""
    x = inp.cpu().numpy()
    rows = x.reshape(-1, x.shape[-1])
    win, hop = cell["win"], cell["hop"]
    out = np.empty((rows.shape[0], -(-rows.shape[1] // hop), win // 2 + 1),
                   np.complex128)

    def one(r: int) -> None:
        out[r] = reference.stft_onesided(rows[r], win, hop)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1,
                                       rows.shape[0]))) as ex:
        list(ex.map(one, range(rows.shape[0])))
    return out.reshape(*x.shape[:-1], *out.shape[1:])


def control(cfg: dict, cell: dict, inp):
    """The reference's function computed in TF32, in the program's place:
    the same framing and window in float32, each frame's DFT in TF32."""
    win, hop = cell["win"], cell["hop"]
    n = inp.shape[-1]
    nf = -(-n // hop)
    pad = torch.nn.functional.pad(inp, (0, (nf - 1) * hop + win - n))
    idx = (torch.arange(nf, device=inp.device)[:, None] * hop
           + torch.arange(win, device=inp.device)[None, :])
    w = torch.tensor(reference.hann(win), dtype=torch.float32,
                     device=inp.device)
    fr = pad[..., idx] * w
    return tf32.dft(fr, torch.zeros_like(fr), win // 2 + 1)
