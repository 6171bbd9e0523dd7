"""kofft_tpu_torch.parallel: mesh-sharded transforms on torch.distributed.

The counterpart of ``kofft_tpu.parallel``: a ``DeviceMesh`` over the
default process group, one rank per device, with explicit collectives
(NCCL on the card, gloo on the CPU): ``all_to_all_single`` for the N-D
and 1-D re-pencils, ``batch_isend_irecv`` for the STFT/ISTFT halos. The
programs take and return ``DTensor``s; their bodies work on the local
blocks and issue exactly the collectives that ``validate.comm_log``
records.
"""

from .mesh import make_mesh, should_shard  # noqa: F401
from .ndfft_sharded import fftn_sharded, ifftn_sharded  # noqa: F401
from .fft_sharded import fft_sharded, ifft_sharded  # noqa: F401
from .stft_sharded import (stft_sharded, istft_sharded,  # noqa: F401
                           stft_sharded_hier, istft_sharded_hier)
from .auto import (calibrate_shard_threshold, fft_auto, fftn_auto,  # noqa: F401
                   istft_auto, stft_auto)
from .hier import (fft_sharded_hier, fftn_sharded_hier,  # noqa: F401
                   ifft_sharded_hier, ifftn_sharded_hier, make_hier_mesh)
