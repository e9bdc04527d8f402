# Copy of veryfasttree_tpu/io/native.py (the port imports none of it).
"""ctypes bindings for the native runtime library (native/vft_native.cpp).

Provides the fast path for FASTA parsing (file bytes -> int8 code matrix in
one pass) and sequence dedup hashing.  Falls back to the pure-Python
implementations in io/alignment.py when the library isn't built; callers can
treat both paths as equivalent (tests assert that).
Build with: make -C native
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


class _ParsedAlignment(ctypes.Structure):
    _fields_ = [
        ("n_seqs", ctypes.c_int64),
        ("n_pos", ctypes.c_int64),
        ("codes", ctypes.POINTER(ctypes.c_int8)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("names_bytes", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libvft_native.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.vft_parse_fasta.restype = ctypes.POINTER(_ParsedAlignment)
    lib.vft_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.vft_free_alignment.argtypes = [ctypes.POINTER(_ParsedAlignment)]
    lib.vft_uniquify.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_fasta_codes(path: str, options) -> Optional[Tuple[List[str], np.ndarray]]:
    """Parse an (uncompressed) FASTA straight into (names, codes[int8 N,P]).
    Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = lib.vft_parse_fasta(path.encode(), options.codes_string.encode(),
                            1 if options.quote else 0)
    try:
        pa = p.contents
        if pa.error:
            raise ValueError(pa.error.decode())
        n, m = pa.n_seqs, pa.n_pos
        codes = np.ctypeslib.as_array(pa.codes, shape=(n, m)).copy()
        raw = ctypes.string_at(pa.names, pa.names_bytes)
        names = raw.decode("latin-1").split("\0")[:-1]
        return names, codes
    finally:
        lib.vft_free_alignment(p)


def uniquify_codes(codes: np.ndarray) -> Optional[np.ndarray]:
    """first_of[i] = index of the first row identical to row i (or None)."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    out = np.zeros(codes.shape[0], dtype=np.int64)
    lib.vft_uniquify(codes, codes.shape[0], codes.shape[1], out)
    return out
