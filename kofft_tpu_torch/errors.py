"""Typed error taxonomy for kofft_tpu_torch.

The same classes as ``kofft_tpu.errors`` (the reference's ``FftError``
enum, ``src/fft.rs:446-454``). A CUDA kernel cannot raise, so every
validation happens eagerly in Python before any launch.
"""

from __future__ import annotations


class KofftError(ValueError):
    """Base class for all kofft-tpu errors."""


class EmptyInputError(KofftError):
    """Input signal has zero length (reference ``FftError::EmptyInput``)."""

    def __init__(self, msg: str = "input must be non-empty"):
        super().__init__(msg)


class MismatchedLengthsError(KofftError):
    """Two buffers that must agree in length do not
    (reference ``FftError::MismatchedLengths``)."""


class InvalidStrideError(KofftError):
    """A stride parameter is zero/negative or inconsistent with the buffer
    (reference ``FftError::InvalidStride``)."""


class InvalidHopSizeError(KofftError):
    """STFT hop size is zero or larger than the window
    (reference ``FftError::InvalidHopSize``)."""


class InvalidValueError(KofftError):
    """A parameter value is out of its legal range
    (reference ``FftError::InvalidValue``)."""


def require(cond: bool, exc: type[KofftError], msg: str) -> None:
    """Eager validation helper — raises *before* tracing/launch."""
    if not cond:
        raise exc(msg)
