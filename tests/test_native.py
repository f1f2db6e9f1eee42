"""C++ geometry kernel vs the numpy reference implementations."""

import numpy as np
import pytest

from goldfish_jax.geometry import native
from goldfish_jax.geometry.preprocessing import (
    _eval_many,
    closest_point_projection,
)
from goldfish_jax.models.slr import roof_patch

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def test_surface_eval_matches_numpy():
    s = roof_patch(5, 3, [50, 100], [0, 25])  # rational (circle arc)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.0, 1.0, size=(40, 2))
    out = native.surface_eval(s, pts, nd=2)
    ref = _eval_many(s, pts, nd=2)
    for k in out:
        assert np.allclose(out[k], ref[k], atol=1e-10), k


def test_closest_point_matches_numpy():
    s = roof_patch(5, 3, [50, 100], [0, 25])
    rng = np.random.default_rng(1)
    uv_true = rng.uniform(0.05, 0.95, size=(30, 2))
    X = _eval_many(s, uv_true, nd=0)[(0, 0)]
    # off-surface points too
    X2 = X + rng.normal(scale=0.3, size=X.shape)
    for pts in (X, X2):
        uv_n, d_n = native.closest_point(s, pts)
        uv_p, d_p = closest_point_projection(s, pts)
        assert np.allclose(d_n, d_p, atol=1e-8), np.abs(d_n - d_p).max()


def test_native_speedup():
    import time

    s = roof_patch(8, 3, [50, 100], [0, 25])
    rng = np.random.default_rng(2)
    X = _eval_many(s, rng.uniform(0, 1, size=(2000, 2)), nd=0)[(0, 0)]
    t0 = time.perf_counter()
    native.closest_point(s, X)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    closest_point_projection(s, X)
    t_numpy = time.perf_counter() - t0
    # informational: native should not be slower
    assert t_native < t_numpy * 2.0, (t_native, t_numpy)
