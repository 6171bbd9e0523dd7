"""Host <-> device transfer helpers."""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..ops._complex import host_device


def asnumpy(x) -> np.ndarray:
    """A tensor (any device, bfloat16 read as float32) as host numpy; a
    ``DTensor`` of ``parallel`` is gathered first (``full_tensor()``, a
    collective: every rank of its mesh calls it)."""
    if isinstance(x, np.ndarray):
        return x
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def planes_from_numpy(xr, xi, device="cuda"):
    """Two host arrays as float32 (float64 kept) plane tensors on
    ``device`` (default the card)."""
    dev = host_device(device)
    out = []
    for a in (xr, xi):
        a = np.asarray(a)
        if a.dtype != np.float64:
            a = a.astype(np.float32)
        out.append(torch.as_tensor(np.ascontiguousarray(a), device=dev))
    return out[0], out[1]
