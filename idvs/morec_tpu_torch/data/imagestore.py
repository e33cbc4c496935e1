"""Image record store + batch transform (JAX twin: idvs/morec_tpu/data/
imagestore.py, copied).

The reference stores PRE-DECODED uint8 HWC arrays in LMDB (LMDB_Image pickles
raw bytes + shape, inbatch_sasrec_e2e_vision/data_utils/dataset.py:16-25).
This module holds:

- MKVStore: the JAX package's mmap'd single-file key-value store with the
  same content model (raw uint8 HWC records), byte for byte the same file
  format. Layout: [MKV1 | u64 n | u64 index_off] [values...] [index: per
  entry u32 klen | key | u64 off | u64 size | u32 h | u32 w | u32 c].
- write_mkv: writes a store from (key, image) records.
- BatchTransform: batched resize-to-R (+ normalize((.5,.5,.5), (.5,.5,.5))
  in 'f32' mode), PIL-BILINEAR-compatible (torchvision transforms parity,
  dataset.py:68-73), through the native library built from
  native/imagestore.cpp (ctypes). The library is compiled on first use with
  the flags of native/Makefile into idvs/morec_tpu_torch/_build/; a build
  that fails raises (there is no slower fallback).

The reference's LMDB databases (LMDBStore) wait: the card's machine has no
``lmdb``.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"MKV1"
_HEADER = struct.Struct("<4sQQ")          # magic, n_entries, index_offset
_IDX_FIXED = struct.Struct("<QQIII")      # off, size, h, w, c

_REPO = Path(__file__).resolve().parents[3]
NATIVE_SOURCE = _REPO / "native" / "imagestore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS, so both packages' libraries compute alike
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread")


# ----------------------------------------------------------------- building
def write_mkv(path: str, records: Iterable[Tuple[bytes, np.ndarray]]) -> int:
    """records: (key, uint8 HWC array). Returns entry count."""
    index = []
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, 0, 0))
        for key, arr in records:
            arr = np.ascontiguousarray(arr, dtype=np.uint8)
            assert arr.ndim == 3, arr.shape
            off = f.tell()
            f.write(arr.tobytes())
            h, w, c = arr.shape
            index.append((key, off, arr.nbytes, h, w, c))
        index_off = f.tell()
        for key, off, size, h, w, c in index:
            f.write(struct.pack("<I", len(key)))
            f.write(key)
            f.write(_IDX_FIXED.pack(off, size, h, w, c))
        f.seek(0)
        f.write(_HEADER.pack(MAGIC, len(index), index_off))
    return len(index)


# ------------------------------------------------------------------ reading
class MKVStore:
    """mmap'd reader; get() returns a zero-copy uint8 HWC view."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, n, index_off = _HEADER.unpack_from(self._mm, 0)
        assert magic == MAGIC, f"not an MKV file: {path}"
        self.index: Dict[bytes, Tuple[int, int, int, int, int]] = {}
        pos = index_off
        for _ in range(n):
            (klen,) = struct.unpack_from("<I", self._mm, pos)
            pos += 4
            key = bytes(self._mm[pos:pos + klen])
            pos += klen
            off, size, h, w, c = _IDX_FIXED.unpack_from(self._mm, pos)
            pos += _IDX_FIXED.size
            self.index[key] = (off, size, h, w, c)

    def __len__(self):
        return len(self.index)

    def get(self, key: bytes) -> np.ndarray:
        off, size, h, w, c = self.index[key]
        return np.frombuffer(self._mm, np.uint8, count=size,
                             offset=off).reshape(h, w, c)

    def close(self):
        self._mm.close()
        self._f.close()


def _starts_with_magic(path: str) -> bool:
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(4) == MAGIC


def open_store(path: str) -> MKVStore:
    """An MKV store (a ``.mkv`` path or a file that starts with its magic);
    anything else is the reference's LMDB, which is not ported."""
    if path.endswith(".mkv") or _starts_with_magic(path):
        return MKVStore(path)
    raise NotImplementedError(
        f"{path!r} is no MKV store; reading the reference's LMDB databases "
        f"is not ported (convert them once with tools/build_store_hm.py)")


# --------------------------------------------------------------- transforms
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the native library of this source and these flags lives."""
    key = hashlib.sha256(NATIVE_SOURCE.read_bytes()
                         + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libimagestore-{key}.so"


def _build(so: Path) -> None:
    """g++ into a temporary file beside ``so``, then an atomic rename, so
    processes that build at once never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", tmp,
                               str(NATIVE_SOURCE)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {NATIVE_SOURCE.name} failed:\n"
                               f"{done.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def native_library() -> ctypes.CDLL:
    """The native transform library, built on first use; raises when it
    cannot be built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for fn, out in (("transform_batch", ctypes.c_float),
                            ("transform_batch_u8", ctypes.c_uint8)):
                getattr(lib, fn).restype = None
                getattr(lib, fn).argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                    ctypes.POINTER(out), ctypes.c_int32, ctypes.c_int32]
            _LIB = lib
    return _LIB


class BatchTransform:
    """uint8 HWC images -> (N, R, R, 3) NHWC.

    mode='f32': normalized to [-1, 1] like torchvision Resize(R, BILINEAR) +
    ToTensor + Normalize(.5, .5) (reference dataset.py:68-73).
    mode='u8': resized uint8 only, a quarter of the bytes to the card; the
    (x/255 - .5)/.5 normalization runs on the device in the tower
    (models/vision_tower.py).
    """

    def __init__(self, resize: int, n_threads: Optional[int] = None,
                 mode: str = "f32"):
        assert mode in ("f32", "u8")
        self.resize = resize
        self.mode = mode
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._lib = native_library()

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        n = len(images)
        r = self.resize
        f32 = self.mode == "f32"
        out = np.empty((n, r, r, 3), np.float32 if f32 else np.uint8)
        ptrs = (ctypes.c_void_p * n)()
        hs = (ctypes.c_int32 * n)()
        ws = (ctypes.c_int32 * n)()
        cs = (ctypes.c_int32 * n)()
        keepalive = []
        for i, img in enumerate(images):
            img = np.ascontiguousarray(img, np.uint8)
            keepalive.append(img)
            ptrs[i] = img.ctypes.data
            hs[i], ws[i], cs[i] = img.shape
        fn = self._lib.transform_batch if f32 else \
            self._lib.transform_batch_u8
        fn(ptrs, hs, ws, cs, n,
           out.ctypes.data_as(ctypes.POINTER(
               ctypes.c_float if f32 else ctypes.c_uint8)),
           r, self.n_threads)
        return out
