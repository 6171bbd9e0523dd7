"""kofft_tpu_torch.media: song identification index."""

from .index import SongId, SongIndex  # noqa: F401
