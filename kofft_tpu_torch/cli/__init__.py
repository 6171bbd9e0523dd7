"""kofft_tpu_torch.cli: command-line tools (the sanity-check spectrogram
renderer)."""
