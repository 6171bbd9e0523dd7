"""The port's host plan and configuration against kofft_tpu.

The port's only state is its constant tables, so carrying the state
across means the port's float32 tables are bit-for-bit those of the JAX
package (exact equality, no tolerance). The host-plan functions that
route shapes must give the same answers for every size class.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kofft_tpu.ops import pallas_kernels as PK  # noqa: E402
from kofft_tpu.plan import tables as jax_tables  # noqa: E402
from kofft_tpu_torch import config as tcfg  # noqa: E402
from kofft_tpu_torch.ops import hopper_kernels as HK  # noqa: E402
from kofft_tpu_torch.plan import (balanced_split, build_factor_tree,  # noqa: E402
                                  factorize, tables)

SIZES = [1 << k for k in range(14, 27)] + [3 << 14, 3 << 18, 5 << 16,
                                           23 << 10, 23 << 14, 9 << 14]


@pytest.mark.parametrize("kind,args", [
    ("dft_matrix", (16,)), ("dft_matrix", (48,)), ("dft_matrix", (80,)),
    ("dft_matrix", (128,)), ("twiddle", (32, 32)), ("twiddle", (16, 48)),
    ("chirp", (4099,))])
def test_tables_bit_equal(kind, args):
    mine = getattr(tables, kind)(*args, "float32")
    theirs = getattr(jax_tables, kind)(*args, "float32")
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("t", [8, 128])
def test_twiddle_factors_bit_equal(t):
    mine = HK._twiddle_factors(1024, 1024, t, "float32")
    theirs = PK._twiddle_factors(1024, 1024, t, "float32")
    for a, b in zip(mine, theirs):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_host_plan_agrees(n):
    assert HK._pow2_split(n) == PK._pow2_split(n)
    sp = HK._pow2_split(n)
    if sp is None:
        return
    for m in sp:
        assert HK._ml_split(m) == PK._ml_split(m)
        assert HK._ml_const_keys(m) == PK._ml_const_keys(m)
    for bt in (1, 2):
        assert HK._use_phased(n, bt) == PK._use_phased(n, bt)
    for b in (1, 2, 3, 8):
        assert HK._ml_batch_tile(b, *sp) == PK._ml_batch_tile(b, *sp)


def _jax_stage_types(n, b, flat, dtype, real, mode):
    """The element types the JAX package's routing loads and keeps C in
    on the chip (pallas_kernels.py:1160-1243, :1260-1345), read off its own
    host plan, as torch types; None where it runs float32 and rounds
    back."""
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    phased = PK._use_phased(n, PK._ml_batch_tile(b, *PK._pow2_split(n)))
    sdt = types[PK._phased_sdt(n, mode, False)]
    flat_cap = (1 << 23) if real else PK._PHASED_FLAT_MAX_N
    if dtype == torch.bfloat16:
        return (torch.bfloat16, sdt) if phased else None
    if phased and flat and n <= flat_cap:
        return torch.float32, torch.float32
    cast = torch.bfloat16 if mode == "default" else torch.float32
    return (cast, sdt) if phased else (cast, cast)


@pytest.mark.parametrize("n", SIZES)
def test_stage_types_agree(n, monkeypatch):
    """The stage kernels' (input type, C type) are the JAX routing's at
    every tier, batch, plane type and form, flat or not."""
    from kofft_tpu import config as jcfg
    if HK._pow2_split(n) is None:
        return
    for mode in ("highest", "high", "default"):
        monkeypatch.setattr(jcfg.get_config(), "precision", mode)
        monkeypatch.setattr(tcfg.get_config(), "precision", mode)
        for b in (1, 2, 3, 8):
            for dtype in (torch.float32, torch.bfloat16):
                for flat in (True, False):
                    for real in (False, True):
                        assert HK._stage_types(n, b, flat, dtype, real) == \
                            _jax_stage_types(n, b, flat, dtype, real, mode), \
                            (n, b, dtype, flat, real, mode)


def test_host_plan_agrees_default_tier(monkeypatch):
    """The phased cap is per tier; both packages read their own config."""
    from kofft_tpu import config as jcfg
    monkeypatch.setattr(jcfg.get_config(), "precision", "default")
    monkeypatch.setattr(tcfg.get_config(), "precision", "default")
    for n in (1 << 23, 1 << 24, 1 << 25):
        assert HK._use_phased(n, 1) == PK._use_phased(n, 1)
    assert HK._use_phased(1 << 24, 1)


def test_ml_const_arrays_bit_equal():
    keys = HK._ml_const_keys(768)
    for a, b in zip(HK._ml_const_arrays(keys, "float32"),
                    PK._ml_const_arrays(keys, "float32")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 12, 97, 1000, 4099, 1 << 14, 3125])
def test_factor_helpers_agree(n):
    from kofft_tpu import plan as jplan
    assert factorize(n) == jplan.factorize(n)
    assert balanced_split(n) == jplan.balanced_split(n)
    assert repr(build_factor_tree(n)) == repr(jplan.build_factor_tree(n))


def test_config_env_parsing(monkeypatch):
    monkeypatch.setenv("KOFFT_TPU_TORCH_BACKEND", "CUFFT")
    monkeypatch.setenv("KOFFT_TPU_TORCH_DFT_CUTOFF", "64")
    monkeypatch.setenv("KOFFT_TPU_TORCH_PRECISION", "default")
    c = tcfg._Config()
    assert (c.backend, c.dft_cutoff, c.precision) == ("cufft", 64, "default")
    monkeypatch.setenv("KOFFT_TPU_TORCH_BACKEND", "pallas")
    with pytest.raises(ValueError):
        tcfg._Config()
    monkeypatch.setenv("KOFFT_TPU_TORCH_BACKEND", "auto")
    monkeypatch.setenv("KOFFT_TPU_TORCH_DFT_CUTOFF", "many")
    with pytest.raises(ValueError):
        tcfg._Config()


def test_config_setters_revert():
    cfg = tcfg.get_config()
    try:
        tcfg.set_backend("torch")
        tcfg.set_precision("high")
        tcfg.set_dft_cutoff(256)
        assert (cfg.backend, cfg.precision, cfg.dft_cutoff) == \
            ("torch", "high", 256)
        assert tcfg.trace_key() == ("high", 256, cfg.max_factor)
        with pytest.raises(ValueError):
            tcfg.set_backend("xla")
        with pytest.raises(ValueError):
            tcfg.set_precision("low")
        with pytest.raises(ValueError):
            tcfg.set_dft_cutoff(1)
    finally:
        tcfg.set_backend(None)
        tcfg.set_precision(None)
        tcfg.set_dft_cutoff(0)
    d = tcfg._env_defaults
    assert (cfg.backend, cfg.precision, cfg.dft_cutoff) == \
        (d.backend, d.precision, d.dft_cutoff)


def test_port_imports_no_jax():
    """Every module of the port (each subpackage: ops, models, visual,
    utils, native, web, and entry) imports neither jax nor kofft_tpu, and
    no source file of the port names either in an import."""
    code = ("import importlib, pkgutil, sys, kofft_tpu_torch as k; "
            "mods = [m.name for m in pkgutil.walk_packages(k.__path__, "
            "'kofft_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'kofft_tpu.'))]; print(len(mods), bad); "
            "sys.exit(1 if bad or len(mods) < 40 else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pattern = re.compile(r"^\s*(import|from)\s+(jax|kofft_tpu)\b", re.M)
    srcs = list(Path(root, "kofft_tpu_torch").rglob("*.py"))
    assert len(srcs) >= 40
    assert not [str(f) for f in srcs if pattern.search(f.read_text())]
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tree_helpers_as_kofft_tpu():
    """The factor-tree helpers of tests/test_plan_config.py against the
    port: a prime is one leaf, and the helpers list leaves and twiddle
    keys as kofft_tpu's do."""
    from kofft_tpu import plan as jplan
    from kofft_tpu_torch.plan import (DftLeaf, tree_leaf_sizes,
                                      tree_twiddle_keys)
    assert balanced_split(7919) == (1, 7919)
    leaf = build_factor_tree(7919)
    assert isinstance(leaf, DftLeaf) and leaf.n == 7919
    t = build_factor_tree(1024, cutoff=32)
    assert tree_leaf_sizes(t) <= {2, 4, 8, 16, 32}
    for n1, n2 in tree_twiddle_keys(t):
        assert n1 * n2 in (1024, 32, 64)
    jt = jplan.build_factor_tree(1024, cutoff=32)
    assert tree_leaf_sizes(t) == jplan.tree_leaf_sizes(jt)
    assert tree_twiddle_keys(t) == jplan.tree_twiddle_keys(jt)


def test_table_cache_clear_and_len():
    """clear() and len() as kofft_tpu.plan's, and clear() also drops the
    device copies (ops._complex._CONST) and the cached launch arguments
    (hopper_kernels._ARGS), which hold pointers into the tables."""
    import torch
    from kofft_tpu_torch.ops import _complex
    tables.dft_matrix(8, "float32")
    _complex.const(tables.dft_matrix(8, "float32")[0], "cpu")
    HK._ARGS["probe"] = (0,)
    assert len(tables) > 0 and _complex._CONST
    tables.clear()
    assert len(tables) == 0
    assert not _complex._CONST and "probe" not in HK._ARGS
    fr, fi = tables.dft_matrix(8, "float32")
    assert fr.shape == (8, 8) and len(tables) == 1
    # the transforms rebuild what they need
    x = torch.ones(1 << 14)
    yr, _ = HK.fused_multilevel_fft(x, torch.zeros_like(x), 1 << 14)
    assert float(yr[0]) == 1 << 14
