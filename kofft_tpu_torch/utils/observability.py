"""Observability helpers: profiler traces, a persistent kernel build
directory, and prewarming.

The counterpart of ``kofft_tpu.utils.observability``. Where the JAX
package keeps XLA's persistent compilation cache, the port keeps its
built kernel library: ``ops/_cuda_build.py`` names the library by a hash
of its sources and flags, so a later process that finds it in the build
directory loads it without running nvcc.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path


def enable_compilation_cache(path: str | Path = "~/.cache/kofft_tpu_torch"
                             ) -> str:
    """Build (and look for) the port's kernel library and native host
    library in ``path`` from now on, so that later processes pointed at
    the same directory reuse them; returns the path. A library this
    process has loaded already stays loaded."""
    from ..ops import _cuda_build
    p = Path(path).expanduser()
    p.mkdir(parents=True, exist_ok=True)
    _cuda_build.BUILD_DIR = p
    return str(p)


def prewarm(sizes, batch_shape: tuple = (), rfft_sizes=(),
            ndfft_shapes=(), device="cuda"):
    """Build the kernels (on a CUDA ``device``) and run each given size
    once through the public entries (``fft_split``/``ifft_split``,
    ``fft``/``ifft``, ``rfft_split``, ``fftn_split`` both ways), so that
    their host tables and device copies exist before the first real call.
    Combine with :func:`enable_compilation_cache` to keep the build
    across processes."""
    import torch

    from .. import fft, fftn_split, fft_split, ifft, ifft_split, rfft_split
    from ..ops._complex import host_device

    dev = host_device(device)
    if dev.type == "cuda":
        from ..ops import _cuda_build
        _cuda_build.lib()
    for n in sizes:
        z = torch.zeros((*batch_shape, n), device=dev)
        fft_split(z, z)
        ifft_split(z, z)
        zc = torch.zeros((*batch_shape, n), dtype=torch.complex64,
                         device=dev)
        ifft(fft(zc))
    for n in rfft_sizes:
        rfft_split(torch.zeros((*batch_shape, n), device=dev))
    for shape in ndfft_shapes:
        z = torch.zeros(tuple(shape), device=dev)
        yr, yi = fftn_split(z, z)
        fftn_split(yr, yi, inverse=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """``torch.profiler`` trace of the block (CPU activity, and CUDA where
    a card is present), written as a Chrome trace JSON file into
    ``log_dir`` (default ``kofft_tpu_torch_trace`` in the temporary
    directory): ``with trace("/path/t"): run()``; open it in Perfetto or
    chrome://tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    d = Path(log_dir if log_dir is not None else
             Path(tempfile.gettempdir()) / "kofft_tpu_torch_trace")
    d.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(d / f"kofft_tpu_torch.{os.getpid()}.{time.time_ns()}.json"))
