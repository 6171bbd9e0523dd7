"""kofft_tpu_torch.visual: spectrogram rendering (mags, dB, colormaps)."""

from .spectrogram import (Colormap, stft_magnitudes, magnitude_to_db,  # noqa: F401
                          db_scale, map_color_u8, map_color_u16,
                          color_from_magnitude_u8, color_from_magnitude_u16,
                          map_bin_to_pixel, log_scale_bins, render_rgb8,
                          render_rgb16)
