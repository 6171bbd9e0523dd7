"""Carry model weights across from the JAX package.

The JAX package keeps a model's parameters as a NamedTuple of arrays
(``kofft_tpu.models.spectral_net.SpectralNetParams``, ``...denoiser.
SpectralDenoiserParams``) and saves them to ``.npz`` under its pytree key
names (``".mel"``, ``".w_head"``, ...). The port's parameters have the
same fields and layout, so conversion is a copy: these functions take
the JAX params as a NamedTuple, a mapping (keys with or without the
leading dot) or a loaded ``.npz``, and return the port's params as
float32 numpy arrays; :func:`load_into` copies them into a module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..errors import InvalidValueError
from ..utils.transfer import asnumpy
from .denoiser import SpectralDenoiserParams
from .spectral_net import SpectralNetParams


def _convert(p, cls):
    if hasattr(p, "_asdict"):
        fields = p._asdict()
    else:
        keys = p.files if hasattr(p, "files") else list(p.keys())
        fields = {str(k).lstrip("."): p[k] for k in keys}
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise InvalidValueError(f"{cls.__name__} needs {missing}; got "
                                f"{sorted(fields)}")
    return cls(*(np.array(asnumpy(fields[f]), np.float32)
                 for f in cls._fields))


def spectral_net_params(p) -> SpectralNetParams:
    """SpectralNet weights of the JAX package -> the port's params."""
    return _convert(p, SpectralNetParams)


def denoiser_params(p) -> SpectralDenoiserParams:
    """SpectralDenoiser weights of the JAX package -> the port's params."""
    return _convert(p, SpectralDenoiserParams)


def load_into(module: nn.Module, params) -> nn.Module:
    """Copy ``params`` (a params NamedTuple) into ``module``'s parameters
    of the same names, on the module's device; shapes must match."""
    module.load_state_dict({k: torch.tensor(asnumpy(v))
                            for k, v in params._asdict().items()})
    return module
