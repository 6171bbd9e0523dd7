"""Build the CUDA kernels in ``csrc/`` with nvcc at first use and load them
with ctypes.

Every ``csrc/*.cu`` source (``fft_stages.cu``, ``stage1_odd.cu``,
``axis_fft.cu``, ``dense_dft.cu``, ``goertzel.cu`` and ``stft_frames.cu``,
with the headers they include) is
compiled for ``sm_90a`` by its own nvcc process, all started together,
and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library
goes to ``build/kofft_tpu_torch/`` at the root of the checkout, named by
a hash of every source and flag, so a changed source builds anew and an
unchanged one loads at once. There is no fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kofft_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the exported functions
SIGNATURES = {
    "kofft_stage1": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I,
                     _P, _P, _I, _I, _I, _I, _I, _P],
    "kofft_stage1_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                             _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "kofft_stage2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                     _I, _I, _I, _I, _I, _P],
    "kofft_col_fft": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                      _I, _P, _I, _I, _I, _P],
    "kofft_col_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                          _I, _P, _I, _P],
    "kofft_row_fft": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P,
                      _I, _I, _P],
    "kofft_dense_stage_a": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P],
    "kofft_dense_stage_b": [_P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P],
    "kofft_goertzel_scan": [_P, _P, _I, _L, _F, _I, _P],
    "kofft_stft_frames": [_P, _P, _P, _I, _L, _I, _L, _P, _P],
}

_lock = threading.Lock()
_lib = None
# the last build: nvcc/ptxas output, wall seconds (0.0: found built) and
# the path of the library that lib() loaded
build_info = {"log": "", "seconds": None, "path": None}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "kofft_tpu_torch are built from source at first use")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    out = BUILD_DIR / f"kofft_kernels-{_digest()}.so"
    if out.exists():
        build_info.update(log="(found built)", seconds=0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all running at once
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        logs.append(f"-- {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode})")
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = out.with_suffix(f".{tag}.so")
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True)
        logs.append(f"-- link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link (exit {link.returncode})")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    build_info.update(log="".join(logs), seconds=time.perf_counter() - t0)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           f"{build_info['log']}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                path = _build()
                cdll = ctypes.CDLL(str(path))
                build_info["path"] = str(path)
                for fn, argtypes in SIGNATURES.items():
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _lib = cdll
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
