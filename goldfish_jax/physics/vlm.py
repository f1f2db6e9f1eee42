"""Vortex-lattice aerodynamics on the (deformed) wing midsurface.

The in-repo replacement for the reference's external VLM dependency in
the aeroelastic loop (reference: VortexAD coupled to the shell at
demos_csdl_alpha/ex_caddee/kl_shell_aeroelastic_coupling.py:99-195):
a classic steady horseshoe-vortex lattice, written entirely in jnp so
the COUPLED fluid-structure adjoint comes out of jax.grad through both
solvers.

Formulation (Katz & Plotkin-style):
- lattice corner nodes ride the DEFORMED shell midsurface (evaluated
  with the same spline basis as the structure, ops/bspline_jax);
- one horseshoe per panel: bound segment at the panel quarter-chord,
  trailing legs to downstream infinity (+x); a mirror image across
  y = 0 models the symmetric full span;
- no-penetration collocation at panel 3/4-chord centers:
  A Gamma = -V_inf . n_hat  (dense solve — the AIC matrix is small);
- panel forces by Kutta-Joukowski on the bound segments,
  F = rho Gamma (V_inf x l_bound).

Everything is batched/static-shape: the AIC assembly is one pairwise
(N_panels x N_panels) Biot-Savart evaluation (dense, batched), and the
linear solve is a tiny dense system.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = ["Lattice", "build_lattice_param", "lattice_points",
           "solve_panel_forces"]


class Lattice(NamedTuple):
    """Static parametric layout of the lattice on a patch grid."""

    ip: jnp.ndarray       # (Mc+1, Ns+1) int32 patch id per corner node
    xi: jnp.ndarray       # (Mc+1, Ns+1, 2) patch-local coords
    panel_cp: jnp.ndarray  # (n_cp_total,) int32 panel id of each flat CP
    n_chord: int
    n_span: int


def build_lattice_param(n_chord_patches, n_span_patches, mc, ns,
                        cp_uv=None):
    """Lattice of mc x ns panels over an n_chord x n_span patch grid
    whose global parametrization is (u, v) in [0, 1]^2 with patch
    (i, j) covering [i/nc, (i+1)/nc] x [j/ns, (j+1)/ns] (the layout of
    models/wing.build). Returns a `Lattice`; `cp_uv` (optional,
    (n_cp_total, 2) global CP parametric locations) fills `panel_cp`
    for the force-to-CP-field mapping."""
    nc, nsp = n_chord_patches, n_span_patches
    u = np.linspace(0.0, 1.0, mc + 1)
    v = np.linspace(0.0, 1.0, ns + 1)
    U, V = np.meshgrid(u, v, indexing="ij")
    i = np.minimum((U * nc).astype(np.int64), nc - 1)
    j = np.minimum((V * nsp).astype(np.int64), nsp - 1)
    ip = (j * nc + i).astype(np.int32)
    xi = np.stack([U * nc - i, V * nsp - j], axis=-1)

    panel_cp = np.zeros(0, dtype=np.int32)
    if cp_uv is not None:
        pu = np.clip((np.asarray(cp_uv)[:, 0] * mc).astype(np.int64),
                     0, mc - 1)
        pv = np.clip((np.asarray(cp_uv)[:, 1] * ns).astype(np.int64),
                     0, ns - 1)
        panel_cp = (pu * ns + pv).astype(np.int32)
    return Lattice(ip=jnp.asarray(ip), xi=jnp.asarray(xi),
                   panel_cp=jnp.asarray(panel_cp),
                   n_chord=mc, n_span=ns)


def lattice_points(ss, p, q, lat: Lattice, cp, d):
    """Deformed corner nodes (Mc+1, Ns+1, 3): midsurface + displacement
    evaluated at the lattice's static parametric locations."""
    import jax

    from goldfish_jax.ops.bspline_jax import field_at, surface_point

    def one(ipk, xik):
        x = surface_point(ss, p, q, ipk, cp, xik)
        u = field_at(ss, p, q, ipk, d, xik)
        return x + u

    flat_ip = lat.ip.reshape(-1)
    flat_xi = lat.xi.reshape(-1, 2)
    pts = jax.vmap(one)(flat_ip, flat_xi)
    return pts.reshape(lat.ip.shape + (3,))


def _seg_induced(P, A, B):
    """Biot-Savart velocity of a unit-strength finite segment A->B at
    points P: P (N, 3), A/B (M, 3) -> (N, M, 3)."""
    r1 = P[:, None, :] - A[None, :, :]
    r2 = P[:, None, :] - B[None, :, :]
    cr = jnp.cross(r1, r2)
    cr2 = jnp.sum(cr * cr, -1)
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    r0 = B[None] - A[None]
    num = jnp.sum(r0 * r1, -1) / (n1 + 1e-300) \
        - jnp.sum(r0 * r2, -1) / (n2 + 1e-300)
    # vortex-core regularization keeps the self/adjacent terms finite
    core = 1e-8
    k = num / (4.0 * jnp.pi * (cr2 + core))
    return cr * k[..., None]


def _semiinf_induced(P, A, direction):
    """Semi-infinite vortex from A along `direction` (unit, constant)
    at P: (N, M, 3) for unit strength (leg running A -> infinity)."""
    r = P[:, None, :] - A[None, :, :]
    d = direction[None, None, :]
    cr = jnp.cross(d, r)
    cr2 = jnp.sum(cr * cr, -1)
    rn = jnp.linalg.norm(r, axis=-1)
    cosv = jnp.sum(d * r, -1) / (rn + 1e-300)
    core = 1e-8
    k = (1.0 + cosv) / (4.0 * jnp.pi * (cr2 + core))
    return cr * k[..., None]


def _horseshoe_induced(P, A, B, wake_dir):
    """Unit horseshoe: bound A->B plus trailing legs (B -> inf) and
    (inf -> A), wake along `wake_dir`."""
    vb = _seg_induced(P, A, B)
    vB = _semiinf_induced(P, B, wake_dir)
    vA = _semiinf_induced(P, A, wake_dir)
    return vb + vB - vA


def solve_panel_forces(corners, alpha, V_inf=1.0, rho=1.225,
                       symmetric=True):
    """VLM solve on the given corner grid (Mc+1, Ns+1, 3).

    Returns (F, aux): F (Mc, Ns, 3) panel forces; aux dict with Gamma,
    lift L, panel areas. alpha is the freestream angle of attack in
    the x-z plane."""
    Mc = corners.shape[0] - 1
    Ns = corners.shape[1] - 1
    c00 = corners[:-1, :-1]
    c10 = corners[1:, :-1]
    c01 = corners[:-1, 1:]
    c11 = corners[1:, 1:]

    A = (c00 + 0.25 * (c10 - c00)).reshape(-1, 3)   # quarter chord, n
    B = (c01 + 0.25 * (c11 - c01)).reshape(-1, 3)   # quarter chord, n+1
    colloc = (0.5 * (c00 + c01)
              + 0.75 * (0.5 * (c10 + c11) - 0.5 * (c00 + c01))
              ).reshape(-1, 3)
    nvec = jnp.cross(c11 - c00, c01 - c10)
    area = 0.5 * jnp.linalg.norm(nvec, axis=-1)
    nhat = (nvec / (2.0 * area[..., None] + 1e-300)).reshape(-1, 3)

    wake = jnp.array([jnp.cos(alpha) * 0.0 + 1.0, 0.0, 0.0])
    wake = wake / jnp.linalg.norm(wake)
    Vvec = V_inf * jnp.array([jnp.cos(alpha), 0.0, jnp.sin(alpha)])

    vind = _horseshoe_induced(colloc, A, B, wake)
    if symmetric:
        mir = jnp.array([1.0, -1.0, 1.0])
        vind = vind + _horseshoe_induced(colloc, B * mir, A * mir, wake)
    AIC = jnp.sum(vind * nhat[:, None, :], -1)      # (N, N)
    rhs = -jnp.sum(Vvec * nhat, -1)
    gamma = jnp.linalg.solve(AIC, rhs)

    lvec = (B - A)
    F = rho * gamma[:, None] * jnp.cross(Vvec, lvec)
    F = F.reshape(Mc, Ns, 3)
    aux = {"gamma": gamma.reshape(Mc, Ns),
           "area": area,
           "lift": jnp.sum(F[..., 2])}
    return F, aux


def forces_to_cp_field(lat: Lattice, F, area, layout_to_padded):
    """Panel forces -> (P, C, 3) CP coefficient force-density field
    (the f_field input of build_field_solve_fn): each CP samples the
    force density F_panel / A_panel of the panel containing its
    parametric location; the displacement basis interpolates between
    samples (exact total-force conservation is not required for the
    coupled adjoint — the mapping itself is part of the differentiated
    model)."""
    dens = F.reshape(-1, 3) / (area.reshape(-1, 1) + 1e-300)
    f_flat = dens[lat.panel_cp]                       # (n_cp_total, 3)
    return layout_to_padded(f_flat)
