"""SpectralNet: a differentiable audio frontend and classifier head.

The counterpart of ``kofft_tpu.models.spectral_net`` (the forward pass;
training comes later):

    signal (B, N) -- STFT (one-sided planes, the port's FFT ladder)
                  -> magnitude (B, F, K)
                  -> learnable mel projection (K, M)
                  -> log -> DCT-II (cached cosine matrix)
                  -> mean over frames -> linear head (M, C)

The parameters keep the JAX layout: ``mel`` is (K, M) and ``w_head``
(M, C), with no transposes, so weights carry across unchanged
(``models.convert``, ``models.checkpoint``). The products are float32
``torch.matmul``s on every precision tier (PyTorch keeps TF32 off for
them by default), where the JAX package runs its einsums at
``lax_precision()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops import stft as _stft
from ..ops import window as _window
from ..ops._complex import const, host_device
from ..ops.cepstrum import mel_filterbank_matrix
from ..ops.dct import _matrix as _dct_matrix


class SpectralNetParams(NamedTuple):
    mel: torch.Tensor     # (K, M) learnable filterbank, mel-initialized
    w_head: torch.Tensor  # (M, C)
    b_head: torch.Tensor  # (C,)


def _on(a, device) -> torch.Tensor:
    """A parameter as float32 on ``device``: a tensor as it is (or
    moved), a host array copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.tensor(a, dtype=torch.float32, device=device)


class SpectralNet(nn.Module):
    """The model's configuration and its parameters ``mel``, ``w_head`` and
    ``b_head`` on ``device`` (initialised by ``init(seed=0)``).

    ``apply(params, signal)`` is the JAX package's pure forward on any
    parameters (it stands in for ``nn.Module.apply``); ``forward(signal)``
    runs it on the module's own."""

    def __init__(self, win_len: int = 256, hop: int = 128,
                 n_mel: int = 32, n_classes: int = 8,
                 sample_rate: float = 16000.0, device="cuda"):
        super().__init__()
        self.win_len = win_len
        self.hop = hop
        self.n_mel = n_mel
        self.n_classes = n_classes
        self.sample_rate = sample_rate
        self.n_bins = win_len // 2 + 1
        self.window = _window.hann(win_len)
        self.device = host_device(device)
        for name, value in self.init(0)._asdict().items():
            setattr(self, name, nn.Parameter(_on(value, self.device)))

    def init(self, seed: int = 0) -> SpectralNetParams:
        """The JAX package's initial parameters, as float32 numpy arrays
        drawn with the same generator."""
        rng = np.random.default_rng(seed)
        mel0 = mel_filterbank_matrix(self.n_bins, self.sample_rate,
                                     self.n_mel)
        w = (rng.standard_normal((self.n_mel, self.n_classes))
             / np.sqrt(self.n_mel)).astype(np.float32)
        return SpectralNetParams(
            mel=mel0, w_head=w,
            b_head=np.zeros((self.n_classes,), np.float32))

    def params(self) -> SpectralNetParams:
        """The module's parameters as a :class:`SpectralNetParams`."""
        return SpectralNetParams(self.mel, self.w_head, self.b_head)

    def apply(self, params: SpectralNetParams, signal):
        """signal (B, N) -> logits (B, C); differentiable. Host input goes
        to the module's device; a tensor is computed where it lies."""
        fr, fi = _stft.stft_split(signal, self.window, self.hop,
                                  onesided=True, backend="torch",
                                  device=self.device)
        dev = fr.device
        mags = torch.sqrt(fr * fr + fi * fi + 1e-12)        # (B, F, K)
        mel = torch.matmul(mags, _on(params.mel, dev))
        logmel = torch.log(torch.abs(mel) + 1e-6)
        dctm = const(_dct_matrix(2, self.n_mel, "float32"), dev)
        pooled = torch.matmul(logmel, dctm).mean(dim=-2)     # (B, M)
        return (torch.matmul(pooled, _on(params.w_head, dev))
                + _on(params.b_head, dev))

    def forward(self, signal):
        return self.apply(self.params(), signal)
