"""Shell-shell contact as a differentiable pair potential.

The reference hooks PENGoLINS/ShNAPr's `ShellContactContext` into
residual assembly (reference: GOLDFISH/nonmatching_opt.py:726-770 —
`assemble_RFE` adds contact K, F when a contact context is set; the
ShNAPr formulation is a volumetric pair potential between shell
quadrature points, Kamensky et al.). Here the same idea is ONE more
term of the scalar total potential:

    W_c = sum_{pairs (A,B)} sum_{qpA, qpB}
          phi(|x_A - x_B|) dA_A dA_B,
    phi(r) = k/6 * (r_max - r)^3   for r < r_max, else 0

(cubic, C^2: a C^1 quadratic potential has a discontinuous Hessian at
the cutoff that makes Newton crawl through the contact layer)

evaluated between the DEFORMED quadrature points of designated patch
pairs — fully batched (pairwise distance matrices are dense matmul work),
and its residual/stiffness contributions come out of jax.grad /
jax.hessian like everything else. No closest-point projection, no
active-set bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from goldfish_jax.geometry.patch_stack import PatchStack
from goldfish_jax.physics.kl_shell import surface_fields

__all__ = ["ContactPairs", "build_contact", "contact_energy",
           "contact_hessians"]


class ContactPairs(NamedTuple):
    """Patch pairs screened for contact; K pairs."""

    pa: jnp.ndarray       # (K,) int32
    pb: jnp.ndarray       # (K,)
    k_pen: jnp.ndarray    # (K,) penalty stiffness (energy/(len^2 area^2))
    r_max: jnp.ndarray    # (K,) interaction cutoff


def build_contact(pairs, k_pen, r_max, dtype=jnp.float64) -> ContactPairs:
    """pairs: [(pa, pb), ...]; k_pen, r_max scalars or per-pair."""
    K = len(pairs)
    return ContactPairs(
        pa=jnp.asarray([p[0] for p in pairs], dtype=jnp.int32),
        pb=jnp.asarray([p[1] for p in pairs], dtype=jnp.int32),
        k_pen=jnp.broadcast_to(jnp.asarray(k_pen, dtype=dtype), (K,)),
        r_max=jnp.broadcast_to(jnp.asarray(r_max, dtype=dtype), (K,)),
    )


def contact_energy(contact: ContactPairs | None, stack: PatchStack, d, cp):
    """Total contact potential (scalar)."""
    if contact is None:
        return jnp.zeros(())
    X = surface_fields(stack, cp)
    u = surface_fields(stack, d)
    x = (X["v"] + u["v"]).reshape(stack.n_patches, -1, 3)  # (P, EQ, 3)
    J = jnp.linalg.norm(jnp.cross(X["du"], X["dv"]), axis=-1)
    w = (J * stack.wq).reshape(stack.n_patches, -1)        # (P, EQ)

    xa = x[contact.pa]   # (K, EQ, 3)
    xb = x[contact.pb]
    wa = w[contact.pa]   # (K, EQ)
    wb = w[contact.pb]
    d2 = jnp.sum((xa[:, :, None, :] - xb[:, None, :, :]) ** 2, -1)
    r = jnp.sqrt(d2 + 1e-30)
    gap = jnp.maximum(contact.r_max[:, None, None] - r, 0.0)
    phi = (contact.k_pen[:, None, None] / 6.0) * gap * gap * gap
    return jnp.sum(phi * wa[:, :, None] * wb[:, None, :])


def contact_hessians(contact: ContactPairs, stack: PatchStack, d, cp):
    """Exact contact stiffness blocks d^2 W_c / dd^2, per pair:
    (K, 6*C3, 6*C3)... precisely (K, 2*C*3, 2*C*3) over the stacked
    [patch-A dofs; patch-B dofs] of each contact pair.

    The reference adds the ShNAPr-assembled contact K to the tangent
    inside `assemble_RFE` (reference: GOLDFISH/nonmatching_opt.py:
    726-770); here the block is jax.hessian of the pair energy wrt the
    pair's own dofs. Pairs are unrolled in Python (their count is
    small and static); each Hessian costs 2*C*3 fwd-over-rev passes of
    the (cheap) pair energy, and assembly consumers scatter the four
    quadrants onto the (pa, pb) patch blocks."""
    C = stack.max_cp
    blocks = []
    for k in range(int(contact.pa.shape[0])):
        sub = ContactPairs(pa=contact.pa[k:k + 1],
                           pb=contact.pb[k:k + 1],
                           k_pen=contact.k_pen[k:k + 1],
                           r_max=contact.r_max[k:k + 1])
        pa, pb = contact.pa[k], contact.pb[k]

        def pair_energy(z, sub=sub, pa=pa, pb=pb):
            z = z.reshape(2, C, 3)
            d_full = d.at[pa].set(z[0]).at[pb].set(z[1])
            return contact_energy(sub, stack, d_full, cp)

        z0 = jnp.stack([d[pa], d[pb]]).reshape(-1)
        blocks.append(jax.hessian(pair_energy)(z0))
    return jnp.stack(blocks)  # (K, 2*C*3, 2*C*3)
