"""Blob-store resolution: MTRS natively, LMDB when the package exists.

The reference hard-codes LMDB (dataload.py:75-181). Here ``open_blob_store``
resolves ``<stem>.mrs`` first, then ``<stem>.lmdb`` (only if the ``lmdb``
package is importable), so datasets written by either generator load with
the same call.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from mage_tpu_torch.data.recordio import RecordReader


class LmdbCompatReader:
    """Read-only LMDB reader with ascii integer keys, matching the
    reference's layout (dataload.py:119-129). Requires the lmdb package."""

    def __init__(self, path: str):
        self.path = path
        self._txn = None
        self._count = None
        self._open()

    def _open(self):
        import lmdb

        env = lmdb.open(
            self.path,
            subdir=False,
            readonly=True,
            lock=False,
            readahead=False,
            map_size=1099511627776 * 2,
        )
        self._txn = env.begin()
        self._count = env.stat()["entries"]

    def __getstate__(self):
        return {"path": self.path}

    def __setstate__(self, state):
        self.path = state["path"]
        self._txn = None
        self._count = None

    def _ensure(self):
        if self._txn is None:
            self._open()

    def __len__(self):
        self._ensure()
        return self._count

    def __getitem__(self, idx: int) -> Any:
        self._ensure()
        blob = self._txn.get(f"{idx}".encode("ascii"))
        return pickle.loads(blob)


def open_blob_store(path_or_stem: str):
    """Open ``x.mrs`` / ``x.lmdb``, or resolve a stem by trying both."""
    if path_or_stem.endswith(".mrs"):
        return RecordReader(path_or_stem)
    if path_or_stem.endswith(".lmdb"):
        if os.path.exists(path_or_stem):
            try:
                import lmdb  # noqa: F401
            except ImportError:
                # generators in this environment write MTRS bytes under the
                # requested name; fall through to RecordReader
                return RecordReader(path_or_stem)
            return LmdbCompatReader(path_or_stem)
        alt = path_or_stem[: -len(".lmdb")] + ".mrs"
        if os.path.exists(alt):
            return RecordReader(alt)
        raise FileNotFoundError(path_or_stem)
    for ext in (".mrs", ".lmdb"):
        cand = path_or_stem + ext
        if os.path.exists(cand):
            return open_blob_store(cand)
    raise FileNotFoundError(f"{path_or_stem}{{.mrs,.lmdb}}")
