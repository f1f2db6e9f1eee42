"""Objective / constraint functionals over the shell state.

The reference's explicit-operation layer (GOLDFISH/operations/
int_energy_exop.py, volume_exop.py, compliance_exop.py,
max_vmstress_exop.py) as plain differentiable functions — all gradients
(dJ/du, dJ/dCP, dJ/dh) are jax.grad of these instead of hand-assembled
UFL derivative forms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goldfish_jax.geometry.patch_stack import PatchStack
from goldfish_jax.physics import kl_shell
from goldfish_jax.physics.loads import external_work
from goldfish_jax.solver.system import SystemData

__all__ = ["internal_energy", "volume", "compliance", "max_vm_stress",
           "cp_regu_energy", "internal_energy_regu"]


def internal_energy(data: SystemData, d, cp, h):
    """W_int (reference: operations/int_energy_exop.py:20-53)."""
    return kl_shell.internal_energy(data.stack, d, cp, h, data.E, data.nu)


def volume(data: SystemData, cp, h):
    """Material volume (reference: operations/volume_exop.py:21-27)."""
    return kl_shell.volume(data.stack, cp, h)


def compliance(data: SystemData, d, cp, h):
    """External-load work at equilibrium (reference:
    operations/compliance_exop.py)."""
    return external_work(data.stack, d, cp, data.f_areal, data.point_loads,
                         data.pressure, data.edge_loads, data.f_field)


def cp_regu_energy(data: SystemData, cp, cp_init, regu_para,
                   field: int = 2, h_regu: float = 1e-3):
    """Per-patch CP-smoothness regularization energies (P,):

        r_s = kappa_s * int_s |grad(cp_f - cp_f,init)|^2 dA,
        kappa_s = regu_para * E_s * h_regu^3 / (12 h_a,s (1 - nu_s^2))

    the reference eVTOL driver's regularization term (reference:
    demos_om/shape_opt/eVTOL/int_energy_regu_exop.py:29-41 —
    bending-stiffness-scaled penalty on the surface gradient of the
    optimized CP field's deviation from the initial design; its
    `ha_phy_linear` per-patch length scale is the mean element size
    here). Gradient and dA are taken on the INITIAL geometry, so the
    term is an exact quadratic in cp."""
    stack = data.stack
    f = (cp - cp_init)[..., field] * stack.cp_mask        # (P, C)
    Ff = kl_shell.surface_fields(stack, f[..., None])
    X = kl_shell.surface_fields(stack, cp_init)
    A1, A2 = X["du"], X["dv"]
    a11 = jnp.sum(A1 * A1, -1)
    a12 = jnp.sum(A1 * A2, -1)
    a22 = jnp.sum(A2 * A2, -1)
    det = a11 * a22 - a12 * a12
    fu = Ff["du"][..., 0]
    fv = Ff["dv"][..., 0]
    # |grad f|^2 = f,_alpha a^{alpha beta} f,_beta (padding discipline:
    # padded qps replicate real geometry with zero weight, so det > 0)
    grad2 = (a22 * fu * fu - 2.0 * a12 * fu * fv + a11 * fv * fv) / det
    J = jnp.linalg.norm(jnp.cross(A1, A2), axis=-1)
    per_patch = jnp.sum(grad2 * J * stack.wq, axis=(-2, -1))  # (P,)
    _, mean_el_area = _patch_areas(stack, cp_init)
    ha = jnp.sqrt(jnp.maximum(mean_el_area, 1e-300))
    kappa = regu_para * data.E * h_regu ** 3 / (12.0 * ha
                                                * (1.0 - data.nu ** 2))
    return kappa * per_patch


def internal_energy_regu(data: SystemData, d, cp, h, cp_init, regu_para,
                         field: int = 2, h_regu: float = 1e-3):
    """W_int + the CP-smoothness regularization (the reference eVTOL
    objective, demos_om/shape_opt/eVTOL/int_energy_regu_exop.py)."""
    return internal_energy(data, d, cp, h) + jnp.sum(
        cp_regu_energy(data, cp, cp_init, regu_para, field=field,
                       h_regu=h_regu))


def _patch_areas(stack: PatchStack, cp):
    X = kl_shell.surface_fields(stack, cp)
    J = jnp.linalg.norm(jnp.cross(X["du"], X["dv"]), axis=-1)
    dA = J * stack.wq                      # (P, E, Q)
    el_area = jnp.sum(dA, axis=-1)         # (P, E)
    n_el = jnp.sum(el_area > 0, axis=-1)   # real elements per patch
    mean_el_area = jnp.sum(el_area, -1) / jnp.maximum(n_el, 1)
    return dA, mean_el_area


def max_vm_stress(data: SystemData, d, cp, h, rho: float = 100.0,
                  method: str = "KS", through: str = "top", m=None,
                  alpha=None):
    """Smooth aggregated maximum von Mises stress, two-level.

    Level 1: continuous aggregation of the qp stress field over each
    patch; level 2: discrete aggregation across patches — exactly the
    scheme of reference operations/max_vmstress_exop.py:167-273, with
    its normalization constants: m_i / m are the current per-patch /
    global maxima (frozen via stop_gradient, recomputed per call like
    the reference's `compute_m` per linearize) and alpha is the minimum
    mean element area (`compute_alpha`, :134-142).

    method: 'KS' | 'pnorm' | 'induced power'.
    """
    stack = data.stack
    s = kl_shell.qp_stress_vm(stack, d, cp, h, data.E, data.nu,
                              through=through)  # (P, E, Q)
    dA, mean_el_area = _patch_areas(stack, cp)
    real = dA > 0

    s_masked = jnp.where(real, s, 0.0)
    if m is None:
        m_list = jax.lax.stop_gradient(jnp.max(s_masked, axis=(1, 2)))
        m_list = jnp.maximum(m_list, 1e-30)
        m_glob = jnp.max(m_list)
    else:
        m_list = jnp.broadcast_to(jnp.asarray(m), (stack.n_patches,))
        m_glob = jnp.max(m_list)
    if alpha is None:
        # min over real patches of the mean element area
        has_el = mean_el_area > 0
        alpha = jax.lax.stop_gradient(
            jnp.min(jnp.where(has_el, mean_el_area, jnp.inf)))

    ml = m_list[:, None, None]
    if method == "KS":
        integ = jnp.sum(jnp.exp(rho * (s - ml)) * dA, axis=(1, 2))
        sub = m_list + (1.0 / rho) * jnp.log(integ / alpha + 1e-300)
        glob = m_glob + (1.0 / rho) * jnp.log(
            jnp.sum(jnp.exp(rho * (sub - m_glob))) / alpha + 1e-300)
    elif method == "pnorm":
        integ = jnp.sum((s / ml) ** rho * dA, axis=(1, 2))
        sub = m_list * (integ / alpha) ** (1.0 / rho)
        glob = m_glob * (jnp.sum((sub / m_glob) ** rho) / alpha) ** (1.0 / rho)
    elif method == "induced power":
        num = jnp.sum((s / ml) ** (rho + 1.0) * dA, axis=(1, 2))
        den = jnp.sum((s / ml) ** rho * dA, axis=(1, 2))
        sub = m_list * num / jnp.maximum(den, 1e-300)
        gnum = jnp.sum((sub / m_glob) ** (rho + 1.0))
        gden = jnp.sum((sub / m_glob) ** rho)
        glob = m_glob * gnum / jnp.maximum(gden, 1e-300)
    else:
        raise ValueError(f"unsupported aggregation method {method!r}")
    return glob
