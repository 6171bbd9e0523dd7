"""The counterpart of ``__graft_entry__.entry()``: the forward step of the
flagship model, SpectralNet at win 256, hop 128, 32 mel bands and 8
classes, on a (4, 4096) signal.

    fn, args = entry()        # on the card; entry("cpu") on the CPU
    logits = fn(*args)        # (4, 8)
"""

from __future__ import annotations

import numpy as np
import torch

from .models.spectral_net import SpectralNet, SpectralNetParams
from .ops._complex import host_device


def entry(device="cuda"):
    """(fn, args): ``fn(mel, w_head, b_head, signal)`` runs SpectralNet's
    forward on those tensors; ``args`` are the JAX entry's four arguments
    (``init(seed=0)`` and a seed-0 signal) as tensors on ``device``."""
    dev = host_device(device)
    model = SpectralNet(win_len=256, hop=128, n_mel=32, n_classes=8,
                        device=dev)
    params = model.init(seed=0)

    def fn(mel, w_head, b_head, signal):
        return model.apply(SpectralNetParams(mel, w_head, b_head), signal)

    rng = np.random.default_rng(0)
    signal = rng.standard_normal((4, 4096)).astype(np.float32)
    return fn, tuple(torch.as_tensor(a, device=dev)
                     for a in (*params, signal))
