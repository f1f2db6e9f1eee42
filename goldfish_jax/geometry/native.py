"""ctypes bridge to the C++ geometry kernel (native/geometry_kernel.cpp).

The native runtime component replacing OpenCASCADE's role in the
reference stack (SURVEY.md section 2.4, pythonOCC row): batched NURBS
surface evaluation and closest-point projection on the host. Compiled
on demand with g++ (cached in ~/.cache/goldfish_jax_native); callers
fall back to the pure-numpy implementations when no compiler is
available (`available()` -> False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["available", "surface_eval", "closest_point"]

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "geometry_kernel.cpp")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.environ.get(
        "GOLDFISH_NATIVE_CACHE",
        os.path.expanduser("~/.cache/goldfish_jax_native"))
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"libgoldfish_geom_{tag}.so")
    if os.path.exists(so):
        return so
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", so + ".tmp"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so + ".tmp", so)
        return so
    except Exception:
        return None


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        if os.environ.get("GOLDFISH_NATIVE", "1") == "0":
            return None
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.gt_surface_eval.restype = ctypes.c_int
        lib.gt_surface_eval.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_int, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int,
            dp]
        lib.gt_closest_point.restype = ctypes.c_int
        lib.gt_closest_point.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_int, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, dp, dp]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def _cptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _surf_args(surf):
    ku = np.ascontiguousarray(surf.knots[0], dtype=np.float64)
    kv = np.ascontiguousarray(surf.knots[1], dtype=np.float64)
    ctrl = np.ascontiguousarray(surf.control.reshape(-1, 4),
                                dtype=np.float64)
    p, q = surf.degree
    n_u, n_v = surf.shape
    return ku, kv, ctrl, p, q, n_u, n_v


def surface_eval(surf, pts, nd=2):
    """Batched rational surface evaluation: pts (m, 2) ->
    dict of (m, 3) arrays for keys up to total derivative order nd."""
    lib = _lib()
    assert lib is not None
    ku, kv, ctrl, p, q, n_u, n_v = _surf_args(surf)
    pts = np.ascontiguousarray(pts, dtype=np.float64).reshape(-1, 2)
    m = pts.shape[0]
    stride = {0: 3, 1: 9, 2: 18}[nd]
    out = np.empty((m, stride))
    lib.gt_surface_eval(_cptr(ku), len(ku), _cptr(kv), len(kv), p, q,
                        _cptr(ctrl), n_u, n_v, _cptr(pts), m, nd,
                        _cptr(out))
    keys = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)][: stride // 3]
    return {k: out[:, 3 * i: 3 * i + 3] for i, k in enumerate(keys)}


def closest_point(surf, X, max_it=30, tol=1e-12):
    """Batched projected-Newton closest point: X (m, 3) -> (uv, dist)."""
    lib = _lib()
    assert lib is not None
    ku, kv, ctrl, p, q, n_u, n_v = _surf_args(surf)
    X = np.ascontiguousarray(X, dtype=np.float64).reshape(-1, 3)
    m = X.shape[0]
    uv = np.empty((m, 2))
    dist = np.empty(m)
    lib.gt_closest_point(_cptr(ku), len(ku), _cptr(kv), len(kv), p, q,
                         _cptr(ctrl), n_u, n_v, _cptr(X), m, max_it,
                         tol, _cptr(uv), _cptr(dist))
    return uv, dist
