"""Traced NURBS evaluation vs the host-side evaluator, including
xi-derivatives via AD (rational surfaces: SLR roof patches)."""

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.models.slr import roof_patch
from goldfish_jax.models.tbeam import create_surf
from goldfish_jax.ops.bspline import rational_basis_2d
from goldfish_jax.ops.bspline_jax import make_surf_set, surface_point


def _check_surface(surfs, pts):
    ss, (p, q) = make_surf_set(surfs)
    max_cp = ss.w.shape[1]
    cp = np.zeros((len(surfs), max_cp, 3))
    for i, s in enumerate(surfs):
        flat = s.points.reshape(-1, 3)
        cp[i, : flat.shape[0]] = flat
    cp = jnp.asarray(cp)

    f = jax.jit(lambda ip, xi: surface_point(ss, p, q, ip, cp, xi))
    J = jax.jit(jax.jacfwd(lambda ip, xi: surface_point(ss, p, q, ip, cp, xi),
                           argnums=1))
    for ip, s in enumerate(surfs):
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], *s.degree, s.weights, pts, nd=1)
        flat = s.points.reshape(-1, 3)
        for k, xi in enumerate(pts):
            S_ref = tab[(0, 0)][k] @ flat[conn[k]]
            Su_ref = tab[(1, 0)][k] @ flat[conn[k]]
            Sv_ref = tab[(0, 1)][k] @ flat[conn[k]]
            S = np.asarray(f(ip, jnp.asarray(xi)))
            dS = np.asarray(J(ip, jnp.asarray(xi)))
            assert np.allclose(S, S_ref, atol=1e-12), (ip, xi)
            assert np.allclose(dS[:, 0], Su_ref, atol=1e-10), (ip, xi)
            assert np.allclose(dS[:, 1], Sv_ref, atol=1e-10), (ip, xi)


def test_traced_eval_rational_roof():
    surfs = [roof_patch(4, 3, [50, 80], [0, 12.5]),
             roof_patch(5, 3, [80, 100], [0, 12.5])]
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.02, 0.98, size=(7, 2))
    pts = np.concatenate([pts, [[0.0, 0.0], [1.0, 1.0], [0.5, 1.0]]])
    _check_surface(surfs, pts)


def test_traced_eval_polynomial_tbeam():
    pts0 = [[-1.0, 0, 0], [1.0, 0, 0], [-1.0, 20, 0], [1.0, 20, 0]]
    surfs = [create_surf(pts0, 3, 5, 3), create_surf(pts0, 2, 7, 3)]
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.0, 1.0, size=(9, 2))
    _check_surface(surfs, pts)
