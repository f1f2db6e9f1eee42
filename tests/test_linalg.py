"""Mixed-precision GMRES-IR vs native f64 direct solve, on a genuinely
ill-conditioned KL-shell tangent (cond ~ 1e10) — validates the mixed
linear-solver path (solver/linalg.py) on the CPU backend — and the
choice of solver path per platform."""

import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import tbeam
from goldfish_jax.solver import linalg
from goldfish_jax.solver.system import assemble_K


def test_mixed_solve_matches_direct():
    sys = tbeam.build(num_el=4, p=2)
    K = assemble_K(sys.data, sys.zero_displacement(), sys.cp, sys.h_init)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.normal(size=K.shape[0]))

    x_direct = jnp.linalg.solve(K, b)
    x_mixed = linalg.mixed_solve(K, b, tol=1e-12)
    num = float(jnp.linalg.norm(x_mixed - x_direct))
    den = float(jnp.linalg.norm(x_direct))
    assert num / den < 1e-8, num / den


def test_mode_dispatch_cpu_default(monkeypatch):
    monkeypatch.delenv("GOLDFISH_LINEAR", raising=False)
    assert linalg.mode() == "direct"  # tests run on the cpu backend
    linalg.set_mode("mixed")
    try:
        assert linalg.mode() == "mixed"
    finally:
        linalg.set_mode(None)
    monkeypatch.setenv("GOLDFISH_LINEAR", "mixed")
    assert linalg.mode() == "mixed"


@pytest.mark.parametrize("platform, path", [
    ("cpu", "direct"),
    ("gpu", "direct"),   # the winner of the direct/mixed A/B on an H100
    ("metal", None),
    ("rocm", None),
])
def test_platform_path(platform, path):
    """Each platform maps to a measured path; an unknown one raises
    instead of falling back to the mixed path."""
    if path is None:
        with pytest.raises(ValueError, match="no solver path"):
            linalg.platform_path(platform)
    else:
        assert linalg.platform_path(platform) == path


def test_refined_solve_reaches_exact_operator():
    """refined_solve: factor a perturbed copy of the tangent, refine
    against the exact one — the answer is the exact operator's, where
    the unrefined one carries the perturbation; a matrix right-hand
    side works too."""
    sys = tbeam.build(num_el=4, p=2)
    K = assemble_K(sys.data, sys.zero_displacement(), sys.cp, sys.h_init)
    rng = np.random.default_rng(1)
    E = jnp.asarray(rng.normal(size=K.shape))
    K_noisy = K * (1.0 + 1e-9 * (E + E.T))
    B = jnp.asarray(rng.normal(size=(K.shape[0], 2)))
    X_ref = jnp.linalg.solve(K, B)
    rel = lambda X: float(jnp.linalg.norm(X - X_ref)
                          / jnp.linalg.norm(X_ref))
    X0 = linalg.refined_solve(K_noisy, B, lambda X: K @ X, sweeps=0)
    X2 = linalg.refined_solve(K_noisy, B, lambda X: K @ X)
    assert X2.shape == B.shape
    assert rel(X2) < 1e-3 * rel(X0), (rel(X2), rel(X0))
