"""Discrete wavelet transforms: Haar, db2, db4, sym4, coif1, multi-level.

The counterpart of ``kofft_tpu.ops.wavelet``, with its semantics:

  * analysis: approx[i] = sum_k h[k] * x[reflect(2i + k)] (and g for
    detail), with whole-point symmetric reflection at both edges (idx < 0
    -> -idx; idx >= n -> 2(n-1) - idx);
  * synthesis: out[reflect(2i + k)] += gs[k]*approx[i] + hs[k]*detail[i];
  * Haar is plain averaging/differencing with no reflection;
  * multi-level: an odd-length level repeats its last sample before the
    next analysis step.

Filter taps are the published Daubechies/Symlet/Coiflet constants in the
reference library's tap order, with its per-family synthesis banks: for
db4, sym4 and coif1 ``wavelet_forward``/``wavelet_inverse`` are not
perfect reconstruction, which is the contract. ``dwt``/``idwt`` are the
orthogonal DWT with periodic extension (g by the QMF rule), whose inverse
is exact.

Analysis for n >= 2*taps is a stride-2 ``torch.nn.functional.conv1d``
(both filters as output channels) over the signal extended by its
reflected tail; synthesis a stride-2 ``conv_transpose1d`` (the JAX
package's lhs-dilated convolution) whose tail past the edge folds back
with one flipped add. Both run cuDNN in float32 with TF32 off. A tiny n
(several reflections per window) gathers with a host index matrix and
scatters with ``index_add``, as do ``dwt``/``idwt`` at every n. Taps are
float32 tables, float64 for float64 input. Host input goes to ``device``
(default ``"cuda"``); every entry returns tensors.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import EmptyInputError, InvalidValueError, require
from ..plan import tables
from ._complex import const, dtype_name
from .fft import _as_tensor, _host_real

__all__ = ["haar_forward", "haar_inverse", "wavelet_forward",
           "wavelet_inverse", "multi_level_forward", "multi_level_inverse",
           "dwt", "idwt", "dwt_multi", "idwt_multi", "FAMILIES"]

# Filter banks: (analysis_h, analysis_g, synthesis_g, synthesis_h) in the
# reference's exact tap order (wavelet.rs:154-536).
_DB2_H = [0.4829629131445341, 0.8365163037378079, 0.2241438680420134,
          -0.1294095225512604]
_DB2_G = [-0.1294095225512604, -0.2241438680420134, 0.8365163037378079,
          -0.4829629131445341]
_DB4_H = [-0.010597401785069032, 0.0328830116668852, 0.030841381835560764,
          -0.18703481171909309, -0.027983769416859854, 0.6308807679298589,
          0.7148465705529157, 0.2303778133088965]
_DB4_G = [-0.2303778133088965, 0.7148465705529157, -0.6308807679298589,
          -0.027983769416859854, 0.18703481171909309, 0.030841381835560764,
          -0.0328830116668852, -0.010597401785069032]
_SYM4_H = [-0.07576571478927333, -0.02963552764599851, 0.49761866763201545,
           0.8037387518059161, 0.29785779560527736, -0.09921954357684722,
           -0.012603967262037833, 0.0322231006040427]
_SYM4_G = [-0.0322231006040427, -0.012603967262037833, 0.09921954357684722,
           0.29785779560527736, -0.8037387518059161, 0.49761866763201545,
           0.02963552764599851, -0.07576571478927333]
_COIF1_H = [-0.015655728135791993, -0.07273261951252645, 0.3848648468648578,
            0.8525720202116004, 0.3378976624574818, -0.07273261951252645]
_COIF1_G = [0.07273261951252645, 0.3378976624574818, -0.8525720202116004,
            0.3848648468648578, 0.07273261951252645, -0.015655728135791993]

FAMILIES = {
    # name: (h, g, synth_g, synth_h) — synth banks as the reference writes
    # them (gk/hk helpers for db2, wavelet.rs:225-248; literal arrays
    # elsewhere, wavelet.rs:311-336, :417-434, :495-514)
    "db2": (_DB2_H, _DB2_G,
            [0.4829629131445341, 0.8365163037378079, 0.2241438680420134,
             -0.1294095225512604],
            [-0.1294095225512604, -0.2241438680420134, 0.8365163037378079,
             -0.4829629131445341]),
    "db4": (_DB4_H, _DB4_G,
            [0.2303778133088965, 0.7148465705529157, 0.6308807679298589,
             -0.027983769416859854, -0.18703481171909309,
             0.030841381835560764, 0.0328830116668852,
             -0.010597401785069032],
            [-0.010597401785069032, -0.0328830116668852,
             0.030841381835560764, 0.18703481171909309,
             -0.027983769416859854, -0.6308807679298589,
             0.7148465705529157, -0.2303778133088965]),
    "sym4": (_SYM4_H, _SYM4_G,
             [0.0322231006040427, -0.012603967262037833,
              -0.09921954357684722, 0.29785779560527736, 0.8037387518059161,
              0.49761866763201545, -0.02963552764599851,
              -0.07576571478927333],
             [-0.07576571478927333, 0.02963552764599851,
              0.49761866763201545, -0.8037387518059161, 0.29785779560527736,
              0.09921954357684722, -0.012603967262037833,
              -0.0322231006040427]),
    "coif1": (_COIF1_H, _COIF1_G,
              [-0.07273261951252645, 0.3378976624574818, 0.8525720202116004,
               0.3848648468648578, -0.07273261951252645,
               -0.015655728135791993],
              [-0.015655728135791993, 0.07273261951252645,
               0.3848648468648578, -0.8525720202116004, 0.3378976624574818,
               0.07273261951252645]),
}


def _reflect_idx(n: int, taps: int) -> np.ndarray:
    """idx[i, k] = reflect(2i + k) into [0, n) (wavelet.rs reflection)."""
    out = np.zeros((n // 2, taps), dtype=np.int32)
    for i in range(n // 2):
        for k in range(taps):
            idx = 2 * i + k
            while idx < 0 or idx >= n:
                idx = -idx if idx < 0 else 2 * (n - 1) - idx
            out[i, k] = idx
    return out


def _taps(key: tuple, rows, dtype: str) -> np.ndarray:
    """A cached host table of filter taps, one row per filter."""
    return tables.custom(("wavelet_taps", *key, dtype),
                         lambda: np.asarray(rows, dtype=dtype))


def _index(key: tuple, build) -> np.ndarray:
    """A cached host index matrix (int64, as torch indexes)."""
    return tables.custom(("wavelet_idx", *key),
                         lambda: build().astype(np.int64))


@contextlib.contextmanager
def _fp32_conv():
    """cuDNN convolutions in full float32: TF32 off, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _flat(x):
    """(..., n) -> (b, n) and the leading shape."""
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def _forward(x, family: str):
    """Single-level analysis of (..., n) -> (approx, detail), n//2 each."""
    h, g, _, _ = FAMILIES[family]
    taps = len(h)
    n = x.shape[-1]
    dev, dtype = x.device, dtype_name(x)
    bank = const(_taps(("analysis", family), [h, g], dtype), dev)
    if n < 2 * taps:
        idx = const(_index(("reflect", n, taps),
                           lambda: _reflect_idx(n, taps)), dev)
        win = x[..., idx]                                  # (..., n/2, taps)
        return win @ bank[0], win @ bank[1]
    xp = x
    if taps > 2:
        # only the tail leaves [0, n): one reflection suffices for n >= taps
        xp = torch.cat([x, torch.flip(x[..., n - taps + 1: n - 1], (-1,))],
                       dim=-1)
    x2, lead = _flat(xp)
    with _fp32_conv():
        out = F.conv1d(x2[:, None, :], bank[:, None, :], stride=2)
    return (out[:, 0].reshape(*lead, n // 2),
            out[:, 1].reshape(*lead, n // 2))


def _inverse(a, d, family: str):
    """Single-level synthesis of (..., n_half) pairs -> (..., 2*n_half)."""
    _, _, gs, hs = FAMILIES[family]
    taps = len(gs)
    n = 2 * a.shape[-1]
    dev, dtype = a.device, dtype_name(a)
    bank = const(_taps(("synthesis", family), [gs, hs], dtype), dev)
    if n < 2 * taps:
        idx = const(_index(("reflect", n, taps),
                           lambda: _reflect_idx(n, taps)), dev)
        contrib = a[..., :, None] * bank[0] + d[..., :, None] * bank[1]
        out = a.new_zeros((*a.shape[:-1], n))
        return out.index_add(-1, idx.reshape(-1),
                             contrib.reshape(*a.shape[:-1], -1))
    a2, lead = _flat(a)
    d2, _ = _flat(d)
    with _fp32_conv():
        # y[2i + k] += gs[k] a[i] + hs[k] d[i], length n + taps - 2
        y = F.conv_transpose1d(torch.stack([a2, d2], dim=1),
                               bank[:, None, :], stride=2)[:, 0]
    out = y[:, :n]
    if taps > 2:
        out = out.clone()
        out[:, n - taps + 1: n - 1] += torch.flip(y[:, n:], (-1,))
    return out.reshape(*lead, n)


def haar_forward(x, device="cuda"):
    """Single-level Haar: (avg, diff) halves, avg = (x0+x1)/2, diff =
    (x0-x1)/2."""
    x = _host_real(x, device)
    require(x.shape[-1] >= 2, EmptyInputError, "haar needs >= 2 samples")
    h = x.shape[-1] // 2
    ev, od = x[..., 0: 2 * h: 2], x[..., 1: 2 * h: 2]
    return (ev + od) * 0.5, (ev - od) * 0.5


def haar_inverse(avg, diff, device="cuda"):
    """Inverse single-level Haar."""
    a = _as_tensor(avg, device)
    d = _as_tensor(diff, device)
    require(a.shape == d.shape, InvalidValueError,
            "avg/diff shapes must match")
    out = torch.stack([a + d, a - d], dim=-1)
    return out.reshape(*a.shape[:-1], 2 * a.shape[-1])


def _check_family(family: str) -> None:
    require(family in FAMILIES, InvalidValueError,
            f"unknown wavelet family {family!r}; "
            f"available: haar, {sorted(FAMILIES)}")


def wavelet_forward(x, family: str, device="cuda"):
    """Single-level analysis for db2/db4/sym4/coif1 (symmetric reflection
    boundaries). Returns (approx, detail), each of length n//2."""
    if family == "haar":
        return haar_forward(x, device)
    _check_family(family)
    x = _host_real(x, device)
    require(x.shape[-1] >= 2, EmptyInputError,
            "wavelet needs >= 2 samples")
    return _forward(x, family)


def wavelet_inverse(approx, detail, family: str, device="cuda"):
    """Single-level synthesis (scatter-add with reflection)."""
    if family == "haar":
        return haar_inverse(approx, detail, device)
    _check_family(family)
    a = _as_tensor(approx, device)
    d = _as_tensor(detail, device)
    require(a.shape == d.shape, InvalidValueError,
            "approx/detail shapes must match")
    return _inverse(a, d, family)


# --------------------------------------------------------------------------
# perfect-reconstruction DWT: the orthogonal DWT with periodic extension.
# Analysis is an orthogonal matrix (rows h, g shifted by 2i mod n; g by
# the QMF rule g[k] = (-1)^k h[L-1-k]), so synthesis is its transpose.
# --------------------------------------------------------------------------

_PR_H = {
    "haar": [0.7071067811865476, 0.7071067811865476],
    "db2": _DB2_H, "db4": _DB4_H, "sym4": _SYM4_H, "coif1": _COIF1_H,
}


def _qmf(h):
    L = len(h)
    return [((-1.0) ** k) * h[L - 1 - k] for k in range(L)]


def _periodic_idx(n: int, taps: int) -> np.ndarray:
    i = np.arange(n // 2, dtype=np.int64)[:, None] * 2
    return ((i + np.arange(taps, dtype=np.int64)[None, :]) % n).astype(
        np.int32)


def _pr_consts(family: str, n: int, dev, dtype: str):
    h = _PR_H[family]
    bank = const(_taps(("pr", family), [h, _qmf(h)], dtype), dev)
    idx = const(_index(("periodic", n, len(h)),
                       lambda: _periodic_idx(n, len(h))), dev)
    return idx, bank


def _check_pr_family(family: str) -> None:
    require(family in _PR_H, InvalidValueError,
            f"unknown wavelet family {family!r}; available: "
            f"{sorted(_PR_H)}")


def dwt(x, family: str = "haar", device="cuda"):
    """Single-level orthogonal DWT, periodic extension, perfect
    reconstruction. Requires an even length."""
    _check_pr_family(family)
    x = _host_real(x, device)
    n = x.shape[-1]
    require(n >= 2 and n % 2 == 0, InvalidValueError,
            f"dwt needs even length, got {n}")
    idx, bank = _pr_consts(family, n, x.device, dtype_name(x))
    win = x[..., idx]
    return win @ bank[0], win @ bank[1]


def idwt(approx, detail, family: str = "haar", device="cuda"):
    """Exact inverse of :func:`dwt` (transpose of the analysis matrix)."""
    _check_pr_family(family)
    a = _as_tensor(approx, device)
    d = _as_tensor(detail, device)
    require(a.shape == d.shape, InvalidValueError,
            "approx/detail shapes must match")
    n = 2 * a.shape[-1]
    idx, bank = _pr_consts(family, n, a.device, dtype_name(a))
    contrib = a[..., :, None] * bank[0] + d[..., :, None] * bank[1]
    out = a.new_zeros((*a.shape[:-1], n))
    return out.index_add(-1, idx.reshape(-1),
                         contrib.reshape(*a.shape[:-1], -1))


def dwt_multi(x, levels: int, family: str = "haar", device="cuda"):
    """Multi-level PR decomposition (length divisible by 2^levels)."""
    require(levels >= 1, InvalidValueError, "levels must be >= 1")
    cur = _host_real(x, device)
    require(cur.shape[-1] % (1 << levels) == 0, InvalidValueError,
            f"length {cur.shape[-1]} not divisible by 2^{levels}")
    details = []
    for _ in range(levels):
        cur, d = dwt(cur, family)
        details.append(d)
    return cur, details


def idwt_multi(approx, details, family: str = "haar", device="cuda"):
    cur = approx
    for d in reversed(details):
        cur = idwt(cur, d, family, device)
    return cur


def multi_level_forward(x, levels: int, family: str = "haar",
                        device="cuda"):
    """Multi-level decomposition: an odd-length level repeats its last
    sample. Returns (approx, [details...])."""
    require(levels >= 1, InvalidValueError, "levels must be >= 1")
    cur = _host_real(x, device)
    details = []
    for _ in range(levels):
        if cur.shape[-1] % 2 != 0:
            cur = torch.cat([cur, cur[..., -1:]], dim=-1)
        cur, d = wavelet_forward(cur, family)
        details.append(d)
    return cur, details


def multi_level_inverse(approx, details, family: str = "haar",
                        device="cuda"):
    """Multi-level reconstruction. Where the forward side padded an
    odd-length level, a level's approx is one sample longer than its
    detail: the padded tail is dropped, as in the JAX package."""
    cur = _as_tensor(approx, device)
    for d in reversed(details):
        d = _as_tensor(d, device)
        if cur.shape[-1] > d.shape[-1]:
            cur = cur[..., : d.shape[-1]]
        cur = wavelet_inverse(cur, d, family)
    return cur
