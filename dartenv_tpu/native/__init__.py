"""Native (C++) host-side components, loaded via ctypes.

The reference stack's native tier is the DART C++ engine plus ODE's C LCP
(`dart/dynamics/*`, `dart/external/odelcpsolver/lcp.cpp` † — SURVEY.md
§2.4).  In this framework the *hot path* native tier is JAX/XLA/Pallas on
the GPU; this package is the host-side native tier: independent C++
implementations of the same published algorithms (Featherstone ABA,
boxed-LCP Dantzig pivoting) that serve as

  * the GOLDEN reference for validating the on-device solvers
    (tests/test_native_*.py cross-check JAX vs C++ in f64), and
  * a fast CPU fallback for host-side tooling (trace capture, debugging).

Sources live in `native/` at the repo root and are compiled on demand with
g++ (no external deps).  `lib()` returns the loaded CDLL.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO / "native"
_SOURCES = ["lcp_dantzig.cpp", "aba.cpp"]
_LIB_PATH = _SRC_DIR / "libdartenv_native.so"

_lib = None


def build(force: bool = False) -> Path:
    """Compile the native library if missing or stale; returns its path."""
    srcs = [_SRC_DIR / s for s in _SOURCES]
    if not force and _LIB_PATH.exists():
        lib_mtime = _LIB_PATH.stat().st_mtime
        if all(s.stat().st_mtime <= lib_mtime for s in srcs):
            return _LIB_PATH
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", str(_LIB_PATH),
    ] + [str(s) for s in srcs]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return _LIB_PATH


def lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    if _lib is None:
        path = build()
        _lib = ctypes.CDLL(str(path))
        _declare(_lib)
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False


_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def _declare(L: ctypes.CDLL) -> None:
    L.dartenv_lcp_solve.restype = ctypes.c_int
    L.dartenv_lcp_solve.argtypes = [
        ctypes.c_int, _D, _D, _D, _D, _I, _D, _D, _D,
    ]
    L.dartenv_aba.restype = ctypes.c_int
    L.dartenv_aba.argtypes = (
        [ctypes.c_int, ctypes.c_int, _I, _I, _I, _I]
        + [_D] * 13                      # pj/cj frames, axes, inertials,
        + [_D, _D]                       # ... dq, tau
        + [ctypes.c_double, _D, _D]      # dt, f_ext (nullable), ddq_out
    )


def _dp(a):
    return a.ctypes.data_as(_D)


def _ip(a):
    return a.ctypes.data_as(_I)


def _f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _i32(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def lcp_solve(A, b, lo, hi, findex=None, mu=None):
    """Golden boxed-LCP solve (Dantzig pivoting + friction-bound fixed
    point).  Returns (x, w, n_violations)."""
    L = lib()
    A = _f64(A)
    b = _f64(b)
    m = b.shape[0]
    lo = _f64(lo)
    hi = _f64(hi)
    fi = _i32(findex if findex is not None else -np.ones(m))
    mu_a = _f64(mu if mu is not None else np.ones(m))
    x = np.zeros(m, dtype=np.float64)
    w = np.zeros(m, dtype=np.float64)
    bad = L.dartenv_lcp_solve(
        m, _dp(A), _dp(b), _dp(lo), _dp(hi), _ip(fi), _dp(mu_a), _dp(x),
        _dp(w),
    )
    return x, w, int(bad)


def aba(model, q, dq, tau, dt, f_ext_world=None):
    """Golden forward dynamics on a SkelModel (f64, host). Returns ddq."""
    L = lib()
    n = int(np.asarray(q).shape[0])
    nb = model.nb
    parent = _i32(model.parent)
    jtype = _i32(model.joint_type)
    q_start = _i32(model.q_start)
    ndof = _i32(model.ndof)
    args = [
        _f64(model.pj_rot), _f64(model.pj_pos),
        _f64(model.cj_rot), _f64(model.cj_pos), _f64(model.axes),
        _f64(model.mass), _f64(model.com), _f64(model.inertia),
        _f64(model.damping), _f64(model.spring_stiff), _f64(model.rest_pos),
        _f64(model.gravity), _f64(q),
    ]
    dq64 = _f64(dq)
    tau64 = _f64(tau)
    fext = _f64(f_ext_world) if f_ext_world is not None else None
    ddq = np.zeros(n, dtype=np.float64)
    L.dartenv_aba(
        nb, n, _ip(parent), _ip(jtype), _ip(q_start), _ip(ndof),
        *[_dp(a) for a in args],
        _dp(dq64), _dp(tau64), ctypes.c_double(float(dt)),
        _dp(fext) if fext is not None else None,
        _dp(ddq),
    )
    return ddq
