"""Public plan objects and strided transforms: the counterpart of
``kofft_tpu.ops.plan_api``. A plan pins (n, backend, norm); ``warmup``
builds its tables (and, on a card, the kernels) ahead of the first call.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import InvalidStrideError, InvalidValueError, require
from ._complex import host_device
from .fft import _fft_norm_planes, _planes, resolve_backend


class FftPlan:
    """Reusable FFT plan for a fixed size (reference ``FftPlan``)."""

    def __init__(self, n: int, backend: Optional[str] = None,
                 norm: Optional[str] = None):
        require(n >= 1, InvalidValueError, f"n must be >= 1, got {n}")
        self.n = n
        self.backend = resolve_backend(backend)
        self.norm = norm

    def __repr__(self):
        return (f"FftPlan(n={self.n}, backend={self.backend!r}, "
                f"norm={self.norm!r})")

    def _run(self, xr, xi, inverse: bool, device):
        xr, xi = _planes(xr, xi, device)
        require(xr.shape[-1] == self.n, InvalidValueError,
                f"plan is for n={self.n}, got last dim {xr.shape[-1]}")
        return _fft_norm_planes(xr, xi, self.n, inverse, self.norm,
                                self.backend)

    def forward(self, xr, xi, device="cuda"):
        """Planes in/out forward transform along the last axis."""
        return self._run(xr, xi, False, device)

    def inverse(self, yr, yi, device="cuda"):
        return self._run(yr, yi, True, device)

    __call__ = forward

    def warmup(self, batch_shape: tuple = (), device="cuda") -> "FftPlan":
        """Run both directions once on zeros of (batch..., n) on
        ``device`` (default the card)."""
        z = torch.zeros((*batch_shape, self.n), dtype=torch.float32,
                        device=host_device(device))
        self.forward(z, z)
        self.inverse(z, z)
        return self


def fft_strided_split(xr, xi, stride: int, inverse: bool = False,
                      backend: Optional[str] = None,
                      norm: Optional[str] = None, device="cuda"):
    """FFT over elements x[k*stride], k = 0..n-1, for each offset in
    [0, stride): input planes of last-axis length stride * n; returns
    planes of the same shape with each strided line transformed."""
    xr, xi = _planes(xr, xi, device)
    require(stride >= 1, InvalidStrideError,
            f"stride must be >= 1, got {stride}")
    total = xr.shape[-1]
    require(total % stride == 0, InvalidStrideError,
            f"length {total} not divisible by stride {stride}")
    n = total // stride
    batch = xr.shape[:-1]
    ar = xr.reshape(*batch, n, stride).transpose(-1, -2)
    ai = xi.reshape(*batch, n, stride).transpose(-1, -2)
    plan = FftPlan(n, backend=backend, norm=norm)
    yr, yi = plan._run(ar, ai, inverse, device)
    yr = yr.transpose(-1, -2).reshape(*batch, total)
    yi = yi.transpose(-1, -2).reshape(*batch, total)
    return yr, yi
