"""Configuration: env vars read once at import, plus runtime setters.

The counterpart of ``kofft_tpu.config`` with the ``KOFFT_TPU_TORCH_``
prefix. Setters take ``None`` (and 0 for the integer knobs) to revert to
the env/default value, as the JAX package's setters do.

Tunables
--------
KOFFT_TPU_TORCH_BACKEND        auto | cuda | torch | cufft | naive, standing
                               for the JAX package's auto | pallas | xla |
                               jnpfft | naive
KOFFT_TPU_TORCH_DFT_CUTOFF     max n computed by one direct DFT matmul in
                               the plain factor tree (default 128)
KOFFT_TPU_TORCH_PRECISION      highest | high | default. The hand-written
                               kernels compute every tier in float32 FFMA
                               (the `highest` arithmetic), which clears
                               every tier's floor; the exception is the
                               dense four-step pair, whose tensor-core
                               kernels follow the tier as the JAX _build's
                               mode does: 3xTF32 on highest and high, one
                               bf16 pass on default.
KOFFT_TPU_TORCH_MAX_FACTOR     largest smooth prime factor before Bluestein
KOFFT_TPU_TORCH_SHARD_THRESHOLD
                               points per rank below which the auto entries
                               of ``parallel`` stay on one card (default
                               1 << 16)
KOFFT_TPU_TORCH_OVERLAP_CHUNKS chunk count of the sharded programs' overlap
                               pipeline that the auto entries use when the
                               shapes divide (default 4; 1 = sequential)
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Optional

_PREFIX = "KOFFT_TPU_TORCH_"


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(_PREFIX + name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{_PREFIX}{name} must be an integer, got {v!r}")


def _env_str(name: str, default: str, choices: tuple[str, ...]) -> str:
    v = os.environ.get(_PREFIX + name, default).lower()
    if v not in choices:
        raise ValueError(f"{_PREFIX}{name} must be one of {choices}, "
                         f"got {v!r}")
    return v


_BACKENDS = ("auto", "cuda", "torch", "cufft", "naive")
_PRECISIONS = ("highest", "high", "default")


@dataclass
class _Config:
    backend: str = field(
        default_factory=lambda: _env_str("BACKEND", "auto", _BACKENDS))
    dft_cutoff: int = field(
        default_factory=lambda: _env_int("DFT_CUTOFF", 128))
    precision: str = field(
        default_factory=lambda: _env_str("PRECISION", "highest",
                                         _PRECISIONS))
    max_factor: int = field(
        default_factory=lambda: _env_int("MAX_FACTOR", 13))
    shard_threshold: int = field(
        default_factory=lambda: _env_int("SHARD_THRESHOLD", 1 << 16))
    overlap_chunks: int = field(
        default_factory=lambda: _env_int("OVERLAP_CHUNKS", 4))


_config = _Config()
_env_defaults = _Config()  # frozen copy of env-derived values for revert


def get_config() -> _Config:
    return _config


def set_backend(name: Optional[str]) -> None:
    """Override the backend; ``None`` reverts to the env/auto default."""
    if name is None:
        _config.backend = _env_defaults.backend
        return
    name = name.lower()
    if name not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {name!r}")
    _config.backend = name


def set_dft_cutoff(n: Optional[int]) -> None:
    if n is None or n == 0:
        _config.dft_cutoff = _env_defaults.dft_cutoff
        return
    if n < 2:
        raise ValueError("dft_cutoff must be >= 2")
    _config.dft_cutoff = int(n)


def set_precision(p: Optional[str]) -> None:
    if p is None:
        _config.precision = _env_defaults.precision
        return
    p = p.lower()
    if p not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {p!r}")
    _config.precision = p


def set_shard_threshold(n: Optional[int]) -> None:
    """Points per rank gating the sharded routes of the auto entries;
    ``None``/0 reverts to the env/default."""
    if n is None or n == 0:
        _config.shard_threshold = _env_defaults.shard_threshold
        return
    _config.shard_threshold = int(n)


def set_overlap_chunks(k: Optional[int]) -> None:
    """Chunk count of the sharded programs' overlap pipeline in the auto
    entries; ``None``/0 reverts to the env/default, 1 is the sequential
    program."""
    if k is None or k == 0:
        _config.overlap_chunks = _env_defaults.overlap_chunks
        return
    if k < 1:
        raise ValueError("overlap_chunks must be >= 1")
    _config.overlap_chunks = int(k)


@contextlib.contextmanager
def precision_scope(p: str):
    """Precision tier ``p`` for the block; the current tier is restored
    after, also when the block raises."""
    prev = _config.precision
    if prev == p:
        yield
        return
    set_precision(p)
    try:
        yield
    finally:
        set_precision(prev)


def trace_key() -> tuple:
    """Config values that alter the computed plan (precision, factor tree
    shape) — the key of any cached plan that depends on them."""
    return (_config.precision, _config.dft_cutoff, _config.max_factor)
