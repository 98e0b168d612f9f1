"""MTRS: a minimal memory-mapped record store.

Replaces the reference's LMDB files (reference: dataload.py:75-181 reads
``(video, caption)`` pickles from LMDB; the generators write them:
data/mnist_caption_single.py:186-219). LMDB isn't available in this
environment and is overkill for write-once/read-many datasets; MTRS is an
append-only blob file + offset index, mmap'd for zero-copy reads and safe
across DataLoader-style worker forks (each reader re-opens lazily, the
same trick as the reference's ``__setstate__`` re-opening its LMDB txn,
dataload.py:165-172).

Layout (little-endian):
    [0:8)   magic b"MTRS0001"
    [8:16)  uint64 record count N
    [16:24) uint64 index offset
    [24:..) blobs, back to back
    index:  (N+1) uint64 blob boundaries (offsets into the file)
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Any, Iterator

_MAGIC = b"MTRS0001"
_HEADER = struct.Struct("<8sQQ")


class RecordWriter:
    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(_HEADER.pack(_MAGIC, 0, 0))
        self._offsets = [self._f.tell()]
        self._closed = False

    def append(self, blob: bytes) -> int:
        self._f.write(blob)
        self._offsets.append(self._f.tell())
        return len(self._offsets) - 2

    def append_pickle(self, obj: Any) -> int:
        return self.append(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        index_offset = self._f.tell()
        self._f.write(struct.pack(f"<{len(self._offsets)}Q", *self._offsets))
        self._f.seek(0)
        self._f.write(_HEADER.pack(_MAGIC, len(self._offsets) - 1, index_offset))
        self._f.close()
        self._closed = True


class RecordReader:
    """Read-only, picklable (drops the mmap, re-opens lazily in workers)."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._mm: mmap.mmap | None = None
        self._count: int | None = None
        self._index_offset: int | None = None
        self._open()

    def _open(self) -> None:
        f = open(self.path, "rb")
        try:
            magic, count, index_offset = _HEADER.unpack(f.read(_HEADER.size))
            if magic != _MAGIC:
                raise ValueError(f"{self.path}: not an MTRS file")
            if index_offset == 0:
                raise ValueError(f"{self.path}: unclosed/truncated MTRS file")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
        self._count = count
        self._index_offset = index_offset

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._mm = None
        self._count = None
        self._index_offset = None

    def _ensure(self) -> None:
        if self._mm is None:
            self._open()

    def __len__(self) -> int:
        self._ensure()
        return self._count  # type: ignore[return-value]

    def get(self, idx: int) -> bytes:
        self._ensure()
        if not 0 <= idx < self._count:  # type: ignore[operator]
            raise IndexError(idx)
        base = self._index_offset + 8 * idx  # type: ignore[operator]
        start, end = struct.unpack_from("<QQ", self._mm, base)  # type: ignore[arg-type]
        return self._mm[start:end]  # type: ignore[index]

    def __getitem__(self, idx: int) -> Any:
        return pickle.loads(self.get(idx))

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
