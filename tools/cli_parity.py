#!/usr/bin/env python3
"""The sanity-check CLI's images from two FFT engines and from float64.

Writes the seeded 10 s, 16 kHz chirp WAV of ``chip_smoke.chirp_wav`` (and
a 1 s, 8 kHz, 440 Hz tone) under ``build/``, renders each with the JAX
package's CLI ``render`` (on the CPU), the port's ``render`` (on
``--device``) and a float64 numpy render (``chip_smoke.spectrogram_f64``),
and prints, per WAV and flag set, the largest difference in colour levels
and the share of pixels that differ between each pair, as JSON lines.

    JAX_PLATFORMS=cpu python tools/cli_parity.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (win, colormap, scale mode, dynamic range): the defaults, the log scale
# with viridis, and win 256 with fire
FLAGS = [(1024, "inferno", "linear", 120.0), (1024, "viridis", "log", 120.0),
         (256, "fire", "linear", 120.0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=130)
    args = ap.parse_args(argv)

    import chip_smoke as C
    from kofft_tpu.cli.sanity_check import render as jax_render
    from kofft_tpu_torch.cli.sanity_check import render
    from kofft_tpu_torch.utils.audio import read_audio, write_wav

    work = ROOT / "build" / "cli_parity"
    work.mkdir(parents=True, exist_ok=True)
    chirp, tone = work / "chirp.wav", work / "tone440.wav"
    C.chirp_wav(chirp, args.seed)
    t = np.arange(8000) / 8000
    write_wav(tone, 0.5 * np.sin(2 * np.pi * 440 * t), 8000)
    for wav in (chirp, tone):
        x = read_audio(wav)[0]
        for flags in FLAGS:
            imgs = {"jax": jax_render(x, *flags),
                    "port": render(x, *flags, device=args.device),
                    "float64": C.spectrogram_f64(x, *flags)}
            out = {"wav": wav.name, "flags": flags, "device": args.device}
            for a, b in (("port", "jax"), ("port", "float64"),
                         ("jax", "float64")):
                big, share = C.level_diff(imgs[a], imgs[b])
                out[f"{a}_vs_{b}"] = {"max_level_diff": big,
                                      "differing_pixel_share": share}
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
