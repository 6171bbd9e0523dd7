"""kofft_tpu_torch.web: the streaming spectrogram service on the card."""

from .state import StreamingSpectrogram  # noqa: F401
from .server import make_server, app_routes  # noqa: F401
