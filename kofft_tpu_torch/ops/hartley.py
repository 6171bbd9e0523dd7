"""Discrete Hartley Transform.

The counterpart of ``kofft_tpu.ops.hartley``: DHT(x) = Re(FFT(x)) -
Im(FFT(x)) (cas t = cos t + sin t, and the FFT uses cos t - i sin t),
through the port's engine ladder, so a length the stage kernels serve
runs on them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._complex import dtype_name
from .fft import _real_tensor, engine_fft_planes, resolve_backend

__all__ = ["dht", "dht_batch", "dht_multi_channel"]


def dht(x, backend: Optional[str] = None, device="cuda"):
    """DHT along the last axis: X_k = sum_i x_i cas(2*pi*i*k/n)."""
    x = _real_tensor(x, device, "DHT")
    yr, yi = engine_fft_planes(x, torch.zeros_like(x), x.shape[-1], False,
                               dtype_name(x), resolve_backend(backend))
    return yr - yi


def dht_batch(xs, backend: Optional[str] = None, device="cuda"):
    """Batch DHT over the leading dims."""
    return dht(xs, backend=backend, device=device)


def dht_multi_channel(xs, backend: Optional[str] = None, device="cuda"):
    return dht(xs, backend=backend, device=device)
