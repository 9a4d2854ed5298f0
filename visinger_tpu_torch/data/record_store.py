"""Append-only record store: the binarized-dataset container (an own copy of
the JAX package's ``data/record_store.py``, so the port reads the records
its ``Binarizer`` writes).

Pickled records in a flat ``.data`` file with a ``.idx`` offset table (a
``.npy`` int64 array), O(1) random access by seek, a one-item read cache.
Records are unpickled, so read only stores this program or the JAX
package wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np


class RecordWriter:
    def __init__(self, path_prefix: str):
        self.path_prefix = path_prefix
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        self._data = open(f"{path_prefix}.data", "wb")
        self._offsets = [0]

    def add(self, item: Any):
        blob = pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)
        self._data.write(blob)
        self._offsets.append(self._offsets[-1] + len(blob))

    def close(self):
        self._data.close()
        with open(f"{self.path_prefix}.idx", "wb") as f:
            np.save(f, np.asarray(self._offsets, np.int64))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    def __init__(self, path_prefix: str):
        self.path_prefix = path_prefix
        self._offsets = np.load(f"{path_prefix}.idx")
        self._file = None
        self._cache: tuple[int, Any] | None = None

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> Any:
        if self._cache is not None and self._cache[0] == i:
            return self._cache[1]
        if self._file is None:  # opened at first read, in the reading process
            self._file = open(f"{self.path_prefix}.data", "rb")
        self._file.seek(int(self._offsets[i]))
        blob = self._file.read(int(self._offsets[i + 1] - self._offsets[i]))
        item = pickle.loads(blob)
        self._cache = (i, item)
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
