"""Native C++ batch decoders for the byte/bit-domain algebraic codes.

The device compute path is JAX/XLA; these are the HOST-side runtime
kernels (RS/BCH Berlekamp–Massey + Chien + Forney) that the reference keeps
native — compiled on first import with the system g++ into a cached .so and
bound via ctypes. Everything degrades gracefully to the numpy implementations
in fec/galois.py when no toolchain is available (``AVAILABLE`` is False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "orion_native.cpp")
_SO = os.path.join(_HERE, "_orion_native.so")

_lib = None


def _build() -> bool:
    try:
        src_mtime = os.path.getmtime(_SRC)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= src_mtime:
            return True
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               "-o", _SO + ".tmp", _SRC]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(_SO + ".tmp", _SO)
        return True
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rs_decode_batch.argtypes = [ctypes.c_int, ctypes.c_int, u8p,
                                    ctypes.c_int, u8p, u8p]
    lib.rs_decode_batch.restype = None
    lib.bch_decode_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     u8p, ctypes.c_int, u8p, u8p]
    lib.bch_decode_batch.restype = None
    lib.rs_encode_batch.argtypes = [ctypes.c_int, ctypes.c_int, u8p,
                                    ctypes.c_int, u8p]
    lib.rs_encode_batch.restype = None
    lib.bch_encode_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     u8p, ctypes.c_int, u8p]
    lib.bch_encode_batch.restype = None
    _lib = lib
    return lib


AVAILABLE = _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def rs_decode_batch(n: int, n_parity: int, received: np.ndarray):
    """(B, n) byte codewords → ((B, k) messages, (B,) ok flags).

    Failed rows hold the systematic prefix (the frame chain's CRC then
    adjudicates). Returns None if the native library is unavailable.
    """
    lib = _load()
    if lib is None or n_parity > 64:
        # the native fast path's fixed buffers support n_parity <= 64
        # (every deployed config; RS(204,16), RS(60,8), ...); larger codes
        # take the numpy path
        return None
    r = np.ascontiguousarray(received, np.uint8)
    assert r.ndim == 2 and r.shape[1] == n
    B = r.shape[0]
    out = np.empty((B, n - n_parity), np.uint8)
    ok = np.empty(B, np.uint8)
    lib.rs_decode_batch(n, n_parity, _ptr(r), B, _ptr(out), _ptr(ok))
    return out, ok.astype(bool)


def bch_decode_batch(n: int, k: int, t: int, received_bits: np.ndarray):
    """(B, n) bit codewords → ((B, k) message bits, (B,) ok flags)."""
    lib = _load()
    if lib is None or t > 16:
        return None
    r = np.ascontiguousarray(received_bits, np.uint8)
    assert r.ndim == 2 and r.shape[1] == n
    B = r.shape[0]
    out = np.empty((B, k), np.uint8)
    ok = np.empty(B, np.uint8)
    lib.bch_decode_batch(n, k, t, _ptr(r), B, _ptr(out), _ptr(ok))
    return out, ok.astype(bool)


def rs_encode_batch(n: int, n_parity: int, messages: np.ndarray):
    """(B, k) byte messages → (B, n) systematic codewords (FCR=0 generator,
    bit-exact vs fec/galois.py::ReedSolomon.encode). None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(messages, np.uint8)
    assert m.ndim == 2 and m.shape[1] == n - n_parity
    B = m.shape[0]
    out = np.empty((B, n), np.uint8)
    lib.rs_encode_batch(n, n_parity, _ptr(m), B, _ptr(out))
    return out


def bch_encode_batch(n: int, k: int, t: int, message_bits: np.ndarray):
    """(B, k) bit messages → (B, n) systematic BCH codewords (bit-exact vs
    fec/galois.py::Bch.encode)."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(message_bits, np.uint8)
    assert m.ndim == 2 and m.shape[1] == k
    B = m.shape[0]
    out = np.empty((B, n), np.uint8)
    lib.bch_encode_batch(n, k, t, _ptr(m), B, _ptr(out))
    return out
