"""Native (C++) host-side components, bound with ``ctypes``.

Counterpart of the JAX package's ``native/``: the ESE maximin-LHS
annealing optimizer (``ese.cpp``, this package's own copy), which
:mod:`..sampling`'s ``"ese"`` criterion uses when it builds.  Host code,
not a kernel: it runs once per sampling call.

The library is built with ``g++`` at first use into the git-ignored
``native/_build/`` (one file per version of the source, written to a
process-unique name and renamed into place) and loaded from there.
Without ``g++``, or with ``TDQ_NO_NATIVE=1``, :func:`load` returns
``None`` and the sampler keeps its NumPy optimizer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ese.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libtdq_ese_{digest}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class NativeUnavailable(RuntimeError):
    """The native library could not be loaded (no compiler, a build error,
    or ``TDQ_NO_NATIVE=1``) and the caller did not fall back."""

    trace_id = None

    def __init__(self):
        super().__init__("native library unavailable")


def load():
    """The loaded library, built first if needed, or ``None`` when native
    support is unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("TDQ_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            so = _library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            dbl_p = ctypes.POINTER(ctypes.c_double)
            lib.tdq_phi_p.restype = ctypes.c_double
            lib.tdq_phi_p.argtypes = [dbl_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_double]
            lib.tdq_ese_optimize.restype = ctypes.c_double
            lib.tdq_ese_optimize.argtypes = [
                dbl_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            _load_failed = True
            from ..telemetry import log_event
            log_event("tdq.native", f"C++ ESE unavailable ({e}); using the "
                      "NumPy optimizer", level="warning")
    return _lib


def available() -> bool:
    return load() is not None


def phi_p(X: np.ndarray, p: float = 10.0) -> float:
    """The PhiP space-filling criterion through the native library."""
    lib = load()
    if lib is None:
        raise NativeUnavailable()
    X = np.ascontiguousarray(X, dtype=np.float64)
    return lib.tdq_phi_p(X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         X.shape[0], X.shape[1], p)


def ese_optimize(X: np.ndarray, p: float = 10.0, outer_loops: int = 30,
                 inner_loops: int = 20, J: int = 10,
                 seed: int = 0) -> np.ndarray:
    """ESE maximin optimization of a unit-cube LHS design (a copy is
    returned; the input is not modified)."""
    lib = load()
    if lib is None:
        raise NativeUnavailable()
    out = np.ascontiguousarray(X, dtype=np.float64).copy()
    lib.tdq_ese_optimize(out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         out.shape[0], out.shape[1], p, outer_loops,
                         inner_loops, J, np.uint64(seed))
    return out
