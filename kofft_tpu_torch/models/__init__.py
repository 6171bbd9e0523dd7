"""kofft_tpu_torch.models: the JAX package's spectral models as
``nn.Module``s on the port's STFT: SpectralNet (STFT -> learnable mel ->
log -> DCT -> linear head) and SpectralDenoiser (STFT -> mask MLP ->
masked ISTFT), with their training steps (``train_step``,
``denoiser_train_step``: plain SGD on ``torch.autograd.grad``).
"""

from .spectral_net import SpectralNet, train_step  # noqa: F401
from .denoiser import SpectralDenoiser  # noqa: F401
from .denoiser import train_step as denoiser_train_step  # noqa: F401
