"""ctypes wrapper for the native cyclic banded LU solver (csrc/banded.cpp).

Counterpart: ksfd_tpu/native/banded.py.  The exact direct-solve path of
1D problems, the role MUMPS plays in the reference's stage solves.
``csrc/banded.cpp`` is a byte-for-byte copy of the reference's C++; it
is built with g++ at first use into ``ksfd_tpu_torch/_build/<content
hash>/`` (git-ignored).  The compiler writes a file of its own (named
by process and thread) which ``os.replace`` puts in place, so any
number of processes may build at once and none loads a half-written
library (the reference builds in place, ROADMAP Queue C).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.debug import logger
from ..utils.exceptions import KSFDException

logLIN = logger("LINALG")

__all__ = ["CyclicBandedSolver", "band_storage_from_dense",
           "native_available", "library_path"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "banded.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_lib = None
_lock = threading.Lock()


def library_path():
    """Where the build of the current source and flags lands."""
    key = hashlib.sha256(
        "\0".join([SOURCE.read_text(), " ".join(CXX_FLAGS)]).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / key / "libksfd_banded.so"


def _build(lib):
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / ("lib.%d.%d.so" % (os.getpid(), threading.get_ident()))
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    logLIN("building native banded solver:", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.cbanded_factor.restype = ctypes.c_void_p
        lib.cbanded_factor.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f64, ctypes.c_int,
            f64, f64,
        ]
        lib.cbanded_solve.restype = None
        lib.cbanded_solve.argtypes = [ctypes.c_void_p, ctypes.c_int, f64,
                                      f64]
        lib.cbanded_free.restype = None
        lib.cbanded_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available():
    """Whether the library builds and loads here.  Counterpart:
    ksfd_tpu/native/banded.py:native_available."""
    try:
        _load()
        return True
    except Exception as e:  # compiler missing etc.
        logLIN("native banded solver unavailable:", e)
        return False


def band_storage_from_dense(A, kl, ku):
    """Dense (n,n) -> LAPACK band storage (2*kl+ku+1, n):
    band[kl+ku+i-j, j] = A[i, j]; entries outside the band must be
    zero.  Counterpart: ksfd_tpu/native/banded.py:
    band_storage_from_dense."""
    n = A.shape[0]
    band = np.zeros((2 * kl + ku + 1, n), dtype=np.float64)
    for j in range(n):
        lo = max(0, j - ku)
        hi = min(n - 1, j + kl)
        for i in range(lo, hi + 1):
            band[kl + ku + i - j, j] = A[i, j]
    return band


class CyclicBandedSolver:
    """Factor/solve for A = banded(kl, ku) + periodic corner blocks, from
    the band storage of the non-periodic core and its top-right (kl x
    kl, A[0:kl, n-kl:]) and bottom-left (ku x ku, A[n-ku:, 0:ku])
    corners.  Counterpart: ksfd_tpu/native/banded.py:CyclicBandedSolver.
    """

    def __init__(self, n, kl, ku, band, top_right, bottom_left):
        lib = _load()
        self.n, self.kl, self.ku = n, kl, ku
        tr = np.atleast_2d(np.asarray(top_right, dtype=np.float64))
        bl = np.atleast_2d(np.asarray(bottom_left, dtype=np.float64))
        r = tr.shape[1] + bl.shape[1]
        U = np.zeros((n, r), dtype=np.float64)
        W = np.zeros((n, r), dtype=np.float64)
        c = 0
        # top-right: rows 0..tr.rows-1, cols n-tr.cols..n-1
        for a in range(tr.shape[1]):
            U[: tr.shape[0], c] = tr[:, a]
            W[n - tr.shape[1] + a, c] = 1.0
            c += 1
        # bottom-left: rows n-bl.rows..n-1, cols 0..bl.cols-1
        for a in range(bl.shape[1]):
            U[n - bl.shape[0]:, c] = bl[:, a]
            W[a, c] = 1.0
            c += 1
        # column-major (ldab, n) -> flat col-major == C order of transpose
        band = np.ascontiguousarray(
            np.asarray(band, dtype=np.float64).T.reshape(-1))
        self._handle = lib.cbanded_factor(
            n, kl, ku, band, r, np.ascontiguousarray(U),
            np.ascontiguousarray(W),
        )
        if not self._handle:
            raise KSFDException("cyclic banded factorization failed "
                                "(zero pivot)")
        self._lib = lib

    @classmethod
    def from_dense_cyclic(cls, A, kl, ku):
        """From a dense cyclic-banded matrix (tests and small n): the
        banded core plus the two periodic corners."""
        A = np.asarray(A, dtype=np.float64)
        n = A.shape[0]
        core = A.copy()
        top_right = A[:kl, n - kl:].copy()
        bottom_left = A[n - ku:, :ku].copy()
        core[:kl, n - kl:] = 0.0
        core[n - ku:, :ku] = 0.0
        return cls(n, kl, ku, band_storage_from_dense(core, kl, ku),
                   top_right, bottom_left)

    def solve(self, b):
        """Solve A x = b; b may be (n,) or (nrhs, n)."""
        b = np.ascontiguousarray(np.asarray(b, dtype=np.float64))
        single = b.ndim == 1
        if single:
            b = b[None]
        x = np.empty_like(b)
        self._lib.cbanded_solve(self._handle, b.shape[0], b, x)
        return x[0] if single else x

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.cbanded_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
