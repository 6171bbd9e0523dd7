"""kofft_tpu_torch: the PyTorch + CUDA port of kofft_tpu for NVIDIA Hopper.

It ports the 1-D complex and real FFT and the N-D FFT: the public 1-D
entries, the N-D entries (fft2/fft3/fftn, rfftn/irfftn and their split
forms), the engine ladders, Bluestein, plans, and the kernels written by
hand in CUDA for sm_90a (``ops/csrc``): the Bailey four-step stages of
the 1-D transforms and the column and row passes (``col_fft``,
``row_fft``) of the N-D routes. Host input goes to the card unless the
caller passes ``device="cpu"``. It imports torch and never jax.
"""

from .config import (get_config, set_backend, set_dft_cutoff,  # noqa: F401
                     set_precision)
from .errors import (KofftError, EmptyInputError,  # noqa: F401
                     MismatchedLengthsError, InvalidStrideError,
                     InvalidHopSizeError, InvalidValueError)
from .ops.fft import (fft, ifft, fft_batch, ifft_batch,  # noqa: F401
                      fft_split, ifft_split, fft_split_tiled,
                      ifft_split_tiled, tiled_shape, fftfreq, rfftfreq,
                      fftshift, ifftshift)
from .ops.ndfft import (fft2, ifft2, fft3, ifft3, fftn,  # noqa: F401
                        ifftn, fftn_split, rfftn, irfftn, rfftn_split,
                        irfftn_split)
from .ops.plan_api import FftPlan, fft_strided_split  # noqa: F401
from .ops.rfft import rfft, irfft, rfft_split, irfft_split  # noqa: F401
from .utils.transfer import asnumpy, planes_from_numpy  # noqa: F401

__version__ = "0.1.0"
