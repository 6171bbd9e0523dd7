"""Checkpoint save/load for model parameters.

The counterpart of ``kofft_tpu.models.checkpoint``: plain ``.npz`` under
the JAX package's pytree key names (``".mel"``, ``".w_head"``, ...), so a
file saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._complex import host_device
from ..utils.transfer import asnumpy
from .convert import spectral_net_params
from .spectral_net import SpectralNetParams


def save_params(path, params) -> None:
    """Save a params NamedTuple (tensors or arrays) to .npz."""
    np.savez(str(path), **{f".{k}": asnumpy(v)
                           for k, v in params._asdict().items()})


def load_params(path, device="cuda") -> SpectralNetParams:
    """Load SpectralNet params saved by :func:`save_params` (of either
    package) as float32 tensors on ``device``."""
    dev = host_device(device)
    with np.load(str(path)) as z:
        p = spectral_net_params(z)
    return SpectralNetParams(*(torch.as_tensor(a, device=dev) for a in p))
