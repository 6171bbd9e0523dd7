"""kofft_tpu_torch.models: the JAX package's spectral models, forward
passes: SpectralNet (STFT -> learnable mel -> log -> DCT -> linear head)
and SpectralDenoiser (STFT -> mask MLP -> masked ISTFT), as
``nn.Module``s on the port's STFT. Training comes in a later slice.
"""

from .spectral_net import SpectralNet  # noqa: F401
from .denoiser import SpectralDenoiser  # noqa: F401
