"""kofft_tpu_torch: the PyTorch + CUDA port of kofft_tpu for NVIDIA Hopper.

It ports the 1-D complex and real FFT and the N-D FFT: the public 1-D
entries, the N-D entries (fft2/fft3/fftn, rfftn/irfftn and their split
forms), the engine ladders, Bluestein, plans, and the kernels written by
hand in CUDA for sm_90a (``ops/csrc``): the Bailey four-step stages of
the 1-D transforms and the column and row passes (``col_fft``,
``row_fft``) of the N-D routes. On those ladders sit the windows
(``window``, a submodule), the STFT and ISTFT (batch, frame-level,
streaming classes and chunked device-side streams), and the composite
transforms: DCT and DST I-IV, Hartley, Hilbert, the chirp Z-transform,
cepstrum and MFCC, Goertzel (its recurrence a CUDA kernel of its own,
``goertzel_scan``) and the wavelets. Above them sit the spectrogram
utilities (``visual``), the host utilities (``utils``, ``native``), the
models' forward passes (``models``, ``entry``) and the streaming
spectrogram server (``web``). ``parallel`` shards the 1-D, N-D and STFT
programs over a ``torch.distributed`` device mesh (NCCL on the card,
gloo on the CPU). Host input goes to the card unless the
caller passes ``device="cpu"``. It imports torch and never jax.
"""

from .config import (get_config, set_backend, set_dft_cutoff,  # noqa: F401
                     set_overlap_chunks, set_precision, set_shard_threshold)
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
from .ops.stft import (stft, istft, stft_split, istft_split,  # noqa: F401
                       StftStream, StftPushStream, IstftStream,
                       istft_stream_scan, stft_stream_scan)
from .ops.dct import dct, idct, dct1, dct2, dct3, dct4  # noqa: F401
from .ops.dst import dst, dst1, dst2, dst3, dst4  # noqa: F401
from .ops.hartley import dht  # noqa: F401
from .ops.hilbert import hilbert, hilbert_analytic  # noqa: F401
from .ops.czt import czt, czt_fast  # noqa: F401
from .ops.goertzel import (goertzel, goertzel_bins,  # noqa: F401
                           goertzel_scan)
from .ops.cepstrum import real_cepstrum, mel_filterbank, mfcc  # noqa: F401
from .ops.wavelet import (haar_forward, haar_inverse,  # noqa: F401
                          wavelet_forward, wavelet_inverse,
                          multi_level_forward, multi_level_inverse,
                          dwt, idwt, dwt_multi, idwt_multi)
from .ops import window  # noqa: F401
from . import visual  # noqa: F401
from . import parallel  # noqa: F401
from .ops.plan_api import FftPlan, fft_strided_split  # noqa: F401
from .ops.rfft import rfft, irfft, rfft_split, irfft_split  # noqa: F401
from .utils.transfer import asnumpy, planes_from_numpy  # noqa: F401
from .utils.observability import enable_compilation_cache, trace  # noqa: F401

__version__ = "0.1.0"
