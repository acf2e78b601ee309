"""The pYIN HMM Viterbi in C++ for the data pipeline (a copy of the JAX
package's radtts_tpu/native): viterbi.cpp is compiled by g++ at first use
into build/radtts_tpu_torch/ at the repository root (named by a hash of the
source, as the CUDA sources are) and loaded with ctypes. Without a
compiler, pyin falls back to its numpy Viterbi, which gives the same path.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "viterbi.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                      "radtts_tpu_torch")
with open(_SRC, "rb") as _f:
    _LIB = os.path.join(_BUILD, "libviterbi_%s.so"
                        % hashlib.sha256(_f.read()).hexdigest()[:16])

_lock = threading.Lock()
_lib = None
_build_failed = False


def _compile():
    # -march=native vectorizes the select-form inner loop (AVX-512 on this
    # host: ~4x); fall back to plain -O3 on toolchains without the flag.
    # The tmp name is pid-unique: DataLoader/data.py worker PROCESSES all
    # build on first use, and concurrent writers to one tmp file would
    # corrupt it (os.replace itself is atomic).
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(base[:2] + ["-march=native", "-funroll-loops"]
                       + base[2:], check=True, capture_output=True)
    except subprocess.CalledProcessError:
        subprocess.run(base, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB):
                _compile()
            lib = ctypes.CDLL(_LIB)
            lib.viterbi_log.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.viterbi_log.restype = None
            lib.viterbi_log_banded.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.viterbi_log_banded.restype = None
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib


def banded_structure(log_trans):
    """Detect pYIN's two-block banded transition structure by EQUALITY:
    kron([[1-p, p], [p, 1-p]], L) with L a half-width-`half` band, all
    out-of-band entries bitwise-equal to log(eps) (`voob`). Returns
    (N, half, voob) or None. The banded kernel is exact only under this
    structure, so anything else gets the dense kernel."""
    S = log_trans.shape[0]
    if S % 2 or S < 8:
        return None
    N = S // 2
    voob = log_trans.min()
    nonbg = log_trans != voob
    col0 = np.flatnonzero(nonbg[:N, 0])
    if col0.size in (0, N):  # fully dense or empty first column
        return None
    half = int(col0.max())
    c = np.arange(N)
    band = np.abs(c[:, None] - c[None, :]) <= half
    if not (np.array_equal(nonbg[:N, :N], band)
            and np.array_equal(nonbg[:N, N:], band)
            and np.array_equal(nonbg[N:, :N], band)
            and np.array_equal(nonbg[N:, N:], band)):
        return None
    return N, half, float(voob)


def viterbi_log_native(log_obs, log_trans, log_p_init):
    """C++ Viterbi; returns the state path (T,) int32, or None when the
    native library is unavailable. Dispatches to the banded kernel when
    the transition matrix has pYIN's band structure (~3x at S=722)."""
    lib = _load()
    if lib is None:
        return None
    log_obs = np.ascontiguousarray(log_obs, dtype=np.float64)
    log_trans = np.ascontiguousarray(log_trans, dtype=np.float64)
    log_p_init = np.ascontiguousarray(log_p_init, dtype=np.float64)
    T, S = log_obs.shape
    states = np.empty((T,), dtype=np.int32)
    psi = np.empty((T, S), dtype=np.int32)
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int32)
    banded = banded_structure(log_trans)
    if banded is not None:
        N, half, voob = banded
        lib.viterbi_log_banded(
            log_obs.ctypes.data_as(dptr), log_trans.ctypes.data_as(dptr),
            log_p_init.ctypes.data_as(dptr), ctypes.c_int64(T),
            ctypes.c_int64(N), ctypes.c_int64(half), ctypes.c_double(voob),
            states.ctypes.data_as(iptr), psi.ctypes.data_as(iptr))
        return states
    lib.viterbi_log(
        log_obs.ctypes.data_as(dptr), log_trans.ctypes.data_as(dptr),
        log_p_init.ctypes.data_as(dptr), ctypes.c_int64(T),
        ctypes.c_int64(S), states.ctypes.data_as(iptr),
        psi.ctypes.data_as(iptr))
    return states
