"""SpectralNet: a differentiable audio frontend and classifier head.

The counterpart of ``kofft_tpu.models.spectral_net``, its forward pass
and its training step:

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

``loss_fn`` is the mean cross-entropy of the logits and ``train_step``
one plain SGD step over every field of the params, the gradients from
``torch.autograd.grad``. The log-mel takes its magnitude as JAX
differentiates ``jnp.abs``: an empty mel band (a filterbank column of
zeros, several at the entry's widths) is exactly 0, where JAX's
derivative of |x| is +1 and ``torch.abs``'s is 0.
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


def _abs(x) -> torch.Tensor:
    """|x| with JAX's derivative, select(x >= 0, g, -g): +1 at 0, where
    ``torch.abs`` gives 0. The value equals ``torch.abs``'s (-0.0 stays
    -0.0, equal to 0.0)."""
    return torch.where(x >= 0, x, -x)


def _compute_device(model, x) -> torch.device:
    """Where a step computes: a tensor's device, else the model's."""
    return x.device if isinstance(x, torch.Tensor) else model.device


def _sgd(loss_of, cls, params, device, lr):
    """(new_params, loss): one plain SGD step p - lr * g on every field of
    ``params`` (any sequence of the fields of ``cls``, the model's params
    NamedTuple), returned as a ``cls``. The step differentiates float32
    copies on ``device`` detached from the caller's tensors, so it
    neither accumulates into nor writes into a caller's ``nn.Parameter``;
    the new params are fresh tensors and the loss a 0-d tensor on
    ``device`` (no host sync)."""
    with torch.enable_grad():
        leaves = cls(*(_on(p, device).detach().requires_grad_()
                       for p in params))
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = cls(*(p - lr * g for p, g in zip(leaves, grads)))
    return new, loss.detach()


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
        logmel = torch.log(_abs(mel) + 1e-6)
        dctm = const(_dct_matrix(2, self.n_mel, "float32"), dev)
        pooled = torch.matmul(logmel, dctm).mean(dim=-2)     # (B, M)
        return (torch.matmul(pooled, _on(params.w_head, dev))
                + _on(params.b_head, dev))

    def forward(self, signal):
        return self.apply(self.params(), signal)


def loss_fn(model: SpectralNet, params: SpectralNetParams, signal, labels):
    """Mean cross-entropy of the logits against integer ``labels``. The
    one-hot is built as ``jax.nn.one_hot`` builds it: a label outside
    [0, C) gets a row of zeros (``torch.nn.functional.one_hot`` would
    raise)."""
    logits = model.apply(params, signal)
    logp = torch.log_softmax(logits, dim=-1)
    lab = torch.as_tensor(labels, device=logits.device)
    classes = torch.arange(model.n_classes, device=logits.device)
    onehot = (lab[..., None] == classes).to(logits.dtype)
    return -(onehot * logp).sum(dim=-1).mean()


def train_step(model: SpectralNet, params: SpectralNetParams, signal,
               labels, lr: float = 1e-2):
    """One SGD step: (new_params, loss). ``params`` may be numpy arrays
    (as from ``init``), tensors or the module's own parameters
    (``model.params()``); the step computes on ``signal``'s device (the
    model's for host input)."""
    return _sgd(lambda p: loss_fn(model, p, signal, labels),
                SpectralNetParams, params, _compute_device(model, signal), lr)
