"""The native HNSW index: an in-repo C++ graph index on the host, bound through ctypes.

Counterpart of ``torch_rechub_tpu/serving/hnsw.py``.  ``native/hnsw.cpp`` is
the JAX package's source byte for byte, built with the same compiler and
flags (``g++ -O3 -shared -fPIC -std=c++17``), so for a given ``seed``, ``M``,
``ef_construction`` and insertion order the graph, and every query's ids and
distances, are the JAX package's; the two read each other's index files.

The library builds at the first use, never at import, into ``build/native/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source and the flags: it is written to a temporary file and renamed, so
that processes building at once never load a half-written library.

This is a host index, as in the JAX package: the items and queries are read
on the host (``as_host``: numpy arrays, or tensors on any device, copied).
Metrics: ``"ip"`` (dot, descending), ``"l2"`` (squared distance, ascending),
``"angular"`` (the normalised dot, descending); ``"dot"`` and
``"euclidean"`` are their aliases.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .base import BaseBuilder, BaseIndexer, as_host, simple_context

SOURCE = Path(__file__).resolve().parent / "native" / "hnsw.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_METRICS = {"ip": 0, "l2": 1, "angular": 2, "dot": 0, "euclidean": 1}
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhnsw-{key}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises with g++'s output if the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent builder sees a whole file or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
        lib.hnsw_add.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.hnsw_search.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)]
        lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hnsw_save.restype = ctypes.c_int
        lib.hnsw_load.argtypes = [ctypes.c_char_p]
        lib.hnsw_load.restype = ctypes.c_void_p
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_size.restype = ctypes.c_int
        lib.hnsw_dim.argtypes = [ctypes.c_void_p]
        lib.hnsw_dim.restype = ctypes.c_int
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class HnswIndexer(BaseIndexer):
    def __init__(self, handle, metric: str, ef_search: int):
        self._lib = _load_lib()
        self._handle = handle
        self.metric = metric
        self.ef_search = ef_search
        self.dim = self._lib.hnsw_dim(handle)

    def query(self, embeddings, top_k: int):
        """``(ids int64, distances float32)``, each ``(n, top_k)``: similarities (descending) for ``ip`` and
        ``angular``, squared distances (ascending) for ``l2``; -1 pads a query with fewer than ``top_k`` hits."""
        q = np.ascontiguousarray(as_host(embeddings))
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self.dim:  # the C index reads dim floats a query
            raise ValueError(f"queries of shape {q.shape} for an index of dimension {self.dim}")
        n = q.shape[0]
        ids = np.empty((n, top_k), dtype=np.int32)
        dists = np.empty((n, top_k), dtype=np.float32)
        self._lib.hnsw_search(self._handle, _floats(q), n, top_k, max(self.ef_search, top_k), ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _floats(dists))
        if self.metric in ("ip", "dot", "angular"):
            dists = -dists  # the index's distance is -dot; report the similarity
        return ids.astype(np.int64), dists

    def save(self, file_path) -> None:
        if not self._lib.hnsw_save(self._handle, str(file_path).encode()):
            raise IOError(f"failed to save index to {file_path}")

    def close(self):
        if self._handle:
            self._lib.hnsw_free(self._handle)
            self._handle = None

    @property
    def size(self) -> int:
        return self._lib.hnsw_size(self._handle)


class HnswBuilder(BaseBuilder):
    """The native HNSW builder: ``metric`` ip | l2 | angular, ``M`` links a node, ``ef_construction`` and
    ``ef_search`` beam widths, ``seed`` of the level draws."""

    def __init__(self, metric: str = "ip", M: int = 16, ef_construction: int = 200, ef_search: int = 64, seed: int = 0):
        if metric not in _METRICS:
            raise ValueError(f"metric must be one of {sorted(_METRICS)}, got {metric!r}")
        self.metric = metric
        self.M = M
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.seed = seed

    def from_embeddings(self, embeddings):
        """Insert the rows of an ``(n, d)`` matrix in order; id ``i`` is row ``i``."""
        lib = _load_lib()
        emb = np.ascontiguousarray(as_host(embeddings))
        if emb.ndim != 2:
            raise ValueError(f"an (n, d) embedding matrix is needed, got shape {emb.shape}")
        handle = lib.hnsw_create(emb.shape[1], _METRICS[self.metric], self.M, self.ef_construction, self.seed)
        lib.hnsw_add(handle, _floats(emb), emb.shape[0])
        return simple_context(HnswIndexer(handle, self.metric, self.ef_search))

    def from_index_file(self, index_file):
        lib = _load_lib()
        handle = lib.hnsw_load(str(index_file).encode())
        if not handle:
            raise IOError(f"failed to load index from {index_file}")
        return simple_context(HnswIndexer(handle, self.metric, self.ef_search))
