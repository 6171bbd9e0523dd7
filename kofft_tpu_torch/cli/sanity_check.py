"""sanity-check: render a spectrogram PNG/SVG from an audio file.

The counterpart of ``kofft_tpu.cli.sanity_check``, flag for flag:
positional input/output, --colormap (default inferno), --win-len (1024),
--scale-mode linear|log, --dynamic-range (120 dB), --png-depth
eight|sixteen. The pipeline is the same: read_audio -> stft_magnitudes
(win, hop = win/2) -> optional log rebin of each column ->
color_from_magnitude_u16 -> pixel (x, height-1-y) -> PNG; an ``.svg``
output takes the SVG writer. The STFT magnitudes run on the card; the
colouring is one host pass.

    python -m kofft_tpu_torch.cli.sanity_check in.wav out.png

(console script ``kofft-torch-sanity-check``). ``KOFFT_TPU_TORCH_PLATFORM``
picks the device: ``cuda`` (the default when unset; without a card the
render raises) or ``cpu``. It stands in for the JAX CLI's
``KOFFT_TPU_PLATFORM``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sanity-check",
        description="Render an audio spectrogram to PNG/SVG")
    p.add_argument("input", type=Path, help="input audio file")
    p.add_argument("output", type=Path, help="output PNG (or .svg) file")
    p.add_argument("--colormap", default="inferno",
                   choices=["fire", "legacy", "gray", "viridis", "plasma",
                            "inferno", "rainbow"])
    p.add_argument("--win-len", type=int, default=1024)
    p.add_argument("--scale-mode", default="linear",
                   choices=["linear", "log"])
    p.add_argument("--dynamic-range", type=float, default=120.0)
    p.add_argument("--png-depth", default="eight",
                   choices=["eight", "sixteen"])
    return p


def render(samples: np.ndarray, win_len: int, colormap: str,
           scale_mode: str, dynamic_range: float,
           device="cuda") -> np.ndarray:
    """Magnitudes -> RGB16 image (height = win/2, width = frames), low
    frequencies at the bottom; the STFT runs on ``device``."""
    from ..visual.spectrogram import (Colormap, color_from_magnitude_u16,
                                      log_scale_bins, stft_magnitudes)
    hop = win_len // 2
    mags, max_mag = stft_magnitudes(samples, win_len, hop, device=device)
    height = win_len // 2
    cmap = Colormap.parse(colormap)
    if scale_mode == "log":
        mags = log_scale_bins(mags[:, :height], height - 1)
    img = color_from_magnitude_u16(mags, max_mag, -dynamic_range, cmap)
    # (frames, bins, 3) -> (bins, frames, 3), flip so low freq at bottom
    return img.transpose(1, 0, 2)[::-1]


def platform_device() -> str:
    """The device KOFFT_TPU_TORCH_PLATFORM names: ``cuda`` when unset."""
    from ..config import _env_str
    return _env_str("PLATFORM", "cuda", ("cpu", "cuda"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = platform_device()
    from ..utils.audio import read_audio
    from ..utils.image import save_png, save_svg
    try:
        samples, _sr = read_audio(args.input)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    img = render(samples, args.win_len, args.colormap, args.scale_mode,
                 args.dynamic_range, device=device)
    if args.output.suffix.lower() == ".svg":
        save_svg(img, args.output)
    else:
        save_png(img, args.output, args.png_depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
