"""Song identification index: filename first, content hash second.

The port's copy of ``kofft_tpu.media.index`` (host code, no device work;
reference ``src/media/index.rs:27-87``). The lookup order is the same:
``identify()`` checks the by-name map first (no hashing), then the
by-hash map, then inserts. The reference hashes with BLAKE3; the default
here is hashlib.blake2b with a 32-byte digest, as in the JAX package (the
hash is an internal key; the strategy is the contract), and ``hasher``
takes another.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional


@dataclass(frozen=True)
class SongId:
    """Unique identifier for a song (the indexed path)."""
    path: Path


def _blake2b_file(path: Path) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(8192)
            if not chunk:
                break
            h.update(chunk)
    return h.digest()


class SongIndex:
    """Hybrid name/content-hash index (reference ``SongIndex``)."""

    def __init__(self, hasher: Optional[Callable[[Path], bytes]] = None):
        self._by_name: dict[str, SongId] = {}
        self._by_hash: dict[bytes, SongId] = {}
        self._hash = hasher or _blake2b_file

    def _insert(self, p: Path, digest: bytes) -> SongId:
        sid = SongId(p)
        if p.name:
            self._by_name[p.name] = sid
        self._by_hash[digest] = sid
        return sid

    def index_song(self, path) -> SongId:
        """Hash the file and store it by name and by hash (reference
        ``index_song``, ``index.rs:55-64``)."""
        p = Path(path)
        return self._insert(p, self._hash(p))

    def identify(self, path) -> SongId:
        """Name lookup first (no hashing), then hash lookup, then insert
        (reference ``identify``, ``index.rs:71-87``)."""
        p = Path(path)
        if p.name and p.name in self._by_name:
            return self._by_name[p.name]
        digest = self._hash(p)
        if digest in self._by_hash:
            return self._by_hash[digest]
        return self._insert(p, digest)
