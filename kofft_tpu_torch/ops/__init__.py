"""kofft_tpu_torch.ops — the transform submodules.

The functions are re-exported at the package top level
(``kofft_tpu_torch.fft`` etc.); this namespace keeps the submodules
themselves (``kofft_tpu_torch.ops.stft`` is the module,
``kofft_tpu_torch.stft`` the function), as ``kofft_tpu.ops`` does.
"""

from . import (bluestein, cepstrum, czt, dct, dft, dst, fft,  # noqa: F401
               goertzel, hartley, hilbert, ndfft, rfft, stft, wavelet,
               window)
