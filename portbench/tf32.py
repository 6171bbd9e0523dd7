"""The control of ``correct``: the DFT computed in TF32.

Every configuration here states float32 with TF32 off (the `highest`
tier). The nearest precision below that is TF32: float32 operands rounded
to 10 explicit mantissa bits in every matrix product, sums kept in
float32. ``dft`` computes the reference's function that way (a direct DFT
matrix product up to 2048 points, a four-step of two such products and a
float32 twiddle above), with the rounding done explicitly so that the
control reads the same on the CPU as on the card, whatever the card's
TF32 switch says. It shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

_DIRECT = 2048


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    i = x.contiguous().view(torch.int32)
    keep = (i >> 13) & 1
    return ((i + 0x0FFF + keep) & -0x2000).view(torch.float32)


def _dft_matrix(n: int, m: int, device) -> tuple:
    """(re, im) of exp(-2 pi i j k / n) for j < n, k < m, in float32."""
    jk = np.outer(np.arange(n), np.arange(m)) % n
    ang = -2.0 * np.pi * jk / n
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _cmm(ar, ai, br, bi):
    """Complex product (ar + i ai) @ (br + i bi), operands in TF32."""
    ar, ai, br, bi = map(round_tf32, (ar, ai, br, bi))
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def dft(xr: torch.Tensor, xi: torch.Tensor, bins: int | None = None):
    """The first ``bins`` (default all) DFT bins along the last axis of
    xr + i xi, in TF32."""
    n = xr.shape[-1]
    bins = n if bins is None else bins
    if n <= _DIRECT:
        fr, fi = _dft_matrix(n, bins, xr.device)
        return _cmm(xr, xi, fr, fi)
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    # x[j1 n2 + j2] -> X[k1 + n1 k2]: columns of n1, twiddle, rows of n2
    ar = xr.reshape(*xr.shape[:-1], n1, n2)
    ai = xi.reshape(*xi.shape[:-1], n1, n2)
    f1r, f1i = _dft_matrix(n1, n1, xr.device)
    br, bi = _cmm(f1r, f1i, ar, ai)
    k1j2 = np.outer(np.arange(n1), np.arange(n2))
    ang = -2.0 * np.pi * k1j2 / n
    wr = torch.tensor(np.cos(ang), dtype=torch.float32, device=xr.device)
    wi = torch.tensor(np.sin(ang), dtype=torch.float32, device=xr.device)
    cr, ci = br * wr - bi * wi, br * wi + bi * wr
    f2r, f2i = _dft_matrix(n2, n2, xr.device)
    dr, di = _cmm(cr, ci, f2r, f2i)
    yr = dr.transpose(-1, -2).reshape(*xr.shape[:-1], n)
    yi = di.transpose(-1, -2).reshape(*xr.shape[:-1], n)
    return yr[..., :bins], yi[..., :bins]
