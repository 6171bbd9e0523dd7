"""Factorization, the factor tree, and the host table cache.

A numpy copy of ``kofft_tpu.plan``: importing that module pulls in jax
through ``kofft_tpu/__init__.py``, and this package never imports jax.
Every table is built in float64 with the phase reduced mod n in exact
int64 arithmetic and rounded once to the working dtype, so the float32
tables here are bit-for-bit those of the JAX package (a test holds them
to that). Device copies of a table are made by ``ops._complex.const``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import get_config
from .errors import EmptyInputError, InvalidValueError, require

# --------------------------------------------------------------------------
# factorization
# --------------------------------------------------------------------------

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13)


def factorize(n: int) -> list[int]:
    """Prime factorization over the smooth primes + one leftover cofactor
    (the caller routes a non-smooth cofactor to Bluestein)."""
    require(n >= 1, InvalidValueError, f"n must be >= 1, got {n}")
    out: list[int] = []
    m = n
    for p in _SMALL_PRIMES:
        while m % p == 0:
            out.append(p)
            m //= p
    if m > 1:
        out.append(m)
    return out


def is_smooth(n: int, max_factor: Optional[int] = None) -> bool:
    mf = max_factor if max_factor is not None else get_config().max_factor
    return all(f <= mf for f in factorize(n))


def balanced_split(n: int) -> tuple[int, int]:
    """Split n into n1*n2 with n1 <= n2 as close as possible; (1, n) for a
    prime."""
    best = (1, n)
    best_gap = n
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            gap = abs((n // d) - d)
            if gap < best_gap:
                best_gap = gap
                best = (d, n // d)
    return best


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# host-side table construction (float64, exact integer phase reduction)
# --------------------------------------------------------------------------

def _dft_matrix_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the symmetric DFT matrix F[j,k] = exp(-2πi·jk/n)."""
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n)
    ang = (-2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def _twiddle_matrix_np(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the four-step twiddle W[k1, j2] = exp(-2πi·k1·j2/n)."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)
    j2 = np.arange(n2, dtype=np.int64)
    ph = np.mod(np.outer(k1, j2), n)
    ang = (-2.0 * np.pi / n) * ph.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def chirp_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the Bluestein chirp c[j] = exp(-πi·j²/n); j² is
    reduced mod 2n in integers so the half angle stays exact."""
    j = np.arange(n, dtype=np.int64)
    ph = np.mod(j * j, 2 * n)
    ang = (-np.pi / n) * ph.astype(np.float64)
    return np.cos(ang), np.sin(ang)


# --------------------------------------------------------------------------
# factor tree
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DftLeaf:
    """Direct DFT matmul base case."""
    n: int


@dataclass(frozen=True)
class FourStepNode:
    """n = n1*n2 Bailey split. ``left`` transforms length-n1 lines,
    ``right`` transforms length-n2 lines."""
    n: int
    n1: int
    n2: int
    left: "FactorTree"
    right: "FactorTree"


FactorTree = object  # union[DftLeaf, FourStepNode]


def build_factor_tree(n: int, cutoff: Optional[int] = None) -> FactorTree:
    """The recursive four-step plan for a smooth n."""
    c = cutoff if cutoff is not None else get_config().dft_cutoff
    require(n >= 1, EmptyInputError, "n must be >= 1")
    if n <= c:
        return DftLeaf(n)
    n1, n2 = balanced_split(n)
    if n1 == 1:
        # prime above the cutoff: one big DFT leaf (safety net; the engine
        # sends only smooth n here)
        return DftLeaf(n)
    return FourStepNode(n, n1, n2, build_factor_tree(n1, c),
                        build_factor_tree(n2, c))


def tree_leaf_sizes(tree: FactorTree) -> set[int]:
    """The DFT leaf sizes of a factor tree."""
    if isinstance(tree, DftLeaf):
        return {tree.n}
    return tree_leaf_sizes(tree.left) | tree_leaf_sizes(tree.right)


def tree_twiddle_keys(tree: FactorTree) -> set[tuple[int, int]]:
    """The (n1, n2) twiddle keys of a factor tree's four-step nodes."""
    if isinstance(tree, DftLeaf):
        return set()
    return ({(tree.n1, tree.n2)}
            | tree_twiddle_keys(tree.left)
            | tree_twiddle_keys(tree.right))


# --------------------------------------------------------------------------
# table cache
# --------------------------------------------------------------------------

class _TableCache:
    """Process-wide cache of host numpy tables in their final dtype, keyed
    by (kind, params, dtype). Thread-safe. Caches built on these tables
    (device copies, raw pointers into them) register a hook with
    ``on_clear`` that :meth:`clear` calls, so that none outlives its
    table."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._store: dict[tuple, tuple] = {}
        self._hooks: list = []

    def _get(self, key: tuple, builder):
        with self._lock:
            hit = self._store.get(key)
        if hit is not None:
            return hit
        # a miss: counted and timed by utils.observability, imported here
        # because the utils package imports ops._complex, which imports
        # this module
        from .utils import observability
        val = observability.table_build(builder)
        with self._lock:
            # a double build is benign; keep the first
            return self._store.setdefault(key, val)

    def dft_matrix(self, n: int, dtype: str = "float32"):
        def build():
            re, im = _dft_matrix_np(n)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("dft", n, dtype), build)

    def twiddle(self, n1: int, n2: int, dtype: str = "float32"):
        def build():
            re, im = _twiddle_matrix_np(n1, n2)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("tw", n1, n2, dtype), build)

    def chirp(self, n: int, dtype: str = "float32"):
        def build():
            re, im = chirp_np(n)
            return (re.astype(dtype), im.astype(dtype))

        return self._get(("chirp", n, dtype), build)

    def custom(self, key: tuple, builder):
        """Cache arbitrary derived constants (Bluestein kernels, factored
        twiddles, kernel line plans...)."""
        return self._get(key, builder)

    def on_clear(self, hook) -> None:
        """Call ``hook()`` whenever the cache is cleared."""
        with self._lock:
            self._hooks.append(hook)

    def clear(self) -> None:
        """Drop every table, and through the hooks every cache built on
        them."""
        with self._lock:
            self._store.clear()
            for hook in self._hooks:
                hook()

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


tables = _TableCache()
