"""Split (re, im) complex helpers for the plain PyTorch engines.

Complex data is carried as two real float planes, as in
``kofft_tpu.ops._complex``; complex dtypes appear only at the public API
boundary (``split``/``merge``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..plan import tables

# device copies of host tables, keyed by the host array's id: dropped with
# the tables, whose ids a new table could reuse
_CONST: dict = {}


def _drop_device_copies() -> None:
    # a kernel queued on any stream may still read a copy, and the caching
    # allocator would hand its memory to the next allocation at once: wait
    # for every device that holds one first
    for dev in {t.device for _, t in _CONST.values() if t.is_cuda}:
        torch.cuda.synchronize(dev)
    _CONST.clear()


tables.on_clear(_drop_device_copies)


def dtype_name(t: torch.Tensor) -> str:
    """'float32' for torch.float32 — the key the host tables use."""
    return str(t.dtype).replace("torch.", "")


def host_float_dtype(dtype):
    """The working float dtype for a host input of ``dtype``: float64 (or
    the components of complex128) stays float64, since both the CPU and
    the H100 run it natively; everything else computes in float32."""
    return np.float64 if np.dtype(dtype) == np.float64 else np.float32


def host_float(x) -> np.ndarray:
    """A host array in its working float dtype (see
    :func:`host_float_dtype`): float64 stays float64."""
    x = np.asarray(x)
    ft = host_float_dtype(x.dtype)
    return x.astype(ft) if x.dtype != ft else x


def host_device(device) -> torch.device:
    """The device that host (numpy or list) input goes to. The entries
    default to ``"cuda"``; without a card that raises instead of computing
    on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"host input goes to device={device!r}, but no CUDA device is "
            f"available; pass device='cpu' to compute on the CPU")
    return dev


def const(arr: np.ndarray, device) -> torch.Tensor:
    """Device copy of a cached host table, made once per (table, device).
    The host array is kept alive beside its copy, so its id stays
    unique."""
    key = (id(arr), str(torch.device(device)))
    hit = _CONST.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr),
                                    device=device))
        _CONST[key] = hit
    return hit[1]


def split(x: torch.Tensor):
    """complex tensor -> (re, im) float planes. Real input gets zero imag."""
    if x.is_complex():
        return x.real.contiguous(), x.imag.contiguous()
    return x, torch.zeros_like(x)


def merge(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(re, im) planes -> complex tensor (complex64 for float32 and
    bfloat16 planes, complex128 for float64)."""
    if re.dtype not in (torch.float32, torch.float64):
        re, im = re.float(), im.float()
    return torch.complex(re, im)


def cmul(ar, ai, br, bi):
    """Elementwise complex multiply on planes."""
    return ar * br - ai * bi, ar * bi + ai * br


def conj(ar, ai):
    return ar, -ai


def cmatmul_last(ar, ai, br, bi):
    """``y[..., k] = sum_j a[..., j] * b[j, k]`` as four real matmuls
    (``b`` as host numpy tables or tensors)."""
    dev = ar.device
    if isinstance(br, np.ndarray):
        br, bi = const(br, dev), const(bi, dev)
    rr = torch.matmul(ar, br)
    ii = torch.matmul(ai, bi)
    ri = torch.matmul(ar, bi)
    ir = torch.matmul(ai, br)
    return rr - ii, ri + ir
