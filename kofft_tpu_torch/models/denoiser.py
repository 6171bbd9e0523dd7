"""SpectralDenoiser: an analysis-mask-synthesis pipeline.

The counterpart of ``kofft_tpu.models.denoiser``, its forward pass and
its training step:

    noisy (B, N) -- STFT (two-sided planes)
                 -> log-power features 0.1 * log(|X|^2 + 1e-3) (B, F, K)
                 -> 2-layer relu MLP -> sigmoid mask (B, F, K)
                 -> mask * spectrum (both planes)
                 -> ISTFT (overlap-add, length N) -> denoised (B, N)

The parameters keep the JAX layout (``w1`` (K, H), ``w2`` (H, K)); the
products are float32 ``torch.matmul``s on every precision tier.
``loss_fn`` is the MSE over the overlap-add interior and ``train_step``
one plain SGD step; its gradients reach the mask MLP through the ISTFT's
inverse transforms, the overlap-add and the window-square division.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..errors import InvalidValueError, require
from ..ops import stft as _stft
from ..ops import window as _window
from ..ops._complex import host_device
from .spectral_net import _compute_device, _on, _sgd


class SpectralDenoiserParams(NamedTuple):
    w1: torch.Tensor  # (K, H)
    b1: torch.Tensor  # (H,)
    w2: torch.Tensor  # (H, K)
    b2: torch.Tensor  # (K,)


class SpectralDenoiser(nn.Module):
    """The model's configuration and its parameters ``w1``, ``b1``, ``w2``
    and ``b2`` on ``device`` (initialised by ``init(seed=0)``).
    ``apply(params, noisy)`` is the pure forward (it stands in for
    ``nn.Module.apply``); ``forward(noisy)`` runs it on the module's own
    parameters."""

    def __init__(self, win_len: int = 256, hop: int = 128,
                 hidden: int = 64, device="cuda"):
        super().__init__()
        self.win_len = win_len
        self.hop = hop
        self.hidden = hidden
        self.window = _window.hann(win_len)
        self.device = host_device(device)
        for name, value in self.init(0)._asdict().items():
            setattr(self, name, nn.Parameter(_on(value, self.device)))

    def init(self, seed: int = 0) -> SpectralDenoiserParams:
        """The JAX package's initial parameters as float32 numpy arrays:
        ``w1`` drawn with the same generator, ``w2`` zero (the mask starts
        at sigmoid(b2)), ``b2`` = 2 (the mask open)."""
        rng = np.random.default_rng(seed)
        k = self.win_len
        h = self.hidden
        w1 = (rng.standard_normal((k, h)) / np.sqrt(k)).astype(np.float32)
        return SpectralDenoiserParams(
            w1=w1, b1=np.zeros((h,), np.float32),
            w2=np.zeros((h, k), np.float32),
            b2=np.full((k,), 2.0, np.float32))

    def params(self) -> SpectralDenoiserParams:
        """The module's parameters as a :class:`SpectralDenoiserParams`."""
        return SpectralDenoiserParams(self.w1, self.b1, self.w2, self.b2)

    def apply(self, params: SpectralDenoiserParams, noisy):
        """noisy (B, N) -> denoised (B, N); differentiable. Host input
        goes to the module's device; a tensor is computed where it lies."""
        fr, fi = _stft.stft_split(noisy, self.window, self.hop,
                                  onesided=False, device=self.device)
        n = np.shape(noisy)[-1]
        dev = fr.device
        # the 1e-3 floor bounds d(log)/d(power); the 0.1 scale keeps the
        # features O(1), as in the JAX package
        logmag = 0.1 * torch.log(fr * fr + fi * fi + 1e-3)  # (B, F, K)
        hdn = torch.relu(torch.matmul(logmag, _on(params.w1, dev))
                         + _on(params.b1, dev))
        mask = torch.sigmoid(torch.matmul(hdn, _on(params.w2, dev))
                             + _on(params.b2, dev))          # (B, F, K)
        return _stft.istft_split(fr * mask, fi * mask, self.window,
                                 self.hop, length=n, device=dev)

    def forward(self, noisy):
        return self.apply(self.params(), noisy)


def loss_fn(model: SpectralDenoiser, params: SpectralDenoiserParams,
            noisy, clean):
    """MSE over the overlap-add interior [win:-win]. The first and last
    window of a masked ISTFT are ill-conditioned (the window-square norm
    goes to 0 at the edges), so the loss scores the interior only, as the
    JAX package's does; a signal no longer than 2 * win_len leaves no
    interior and raises."""
    require(np.shape(noisy)[-1] > 2 * model.win_len, InvalidValueError,
            f"denoiser loss needs signals longer than 2*win_len = "
            f"{2 * model.win_len} (the scored OLA interior would be "
            f"empty, yielding a silent NaN loss)")
    out = model.apply(params, noisy)
    ref = torch.as_tensor(clean, dtype=out.dtype, device=out.device)
    w = model.win_len
    return torch.mean((out[..., w:-w] - ref[..., w:-w]) ** 2)


def train_step(model: SpectralDenoiser, params: SpectralDenoiserParams,
               noisy, clean, lr: float = 1e-2):
    """One SGD step: (new_params, loss), as SpectralNet's ``train_step``
    (params as numpy, tensors or ``model.params()``; the step computes on
    ``noisy``'s device, the model's for host input)."""
    return _sgd(lambda p: loss_fn(model, p, noisy, clean),
                SpectralDenoiserParams, params, _compute_device(model, noisy),
                lr)
