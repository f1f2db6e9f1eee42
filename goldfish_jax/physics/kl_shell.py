"""St. Venant-Kirchhoff Kirchhoff-Love shell energy, batched over patches.

The entire structural model is ONE scalar functional

    Pi(d, CP, h) = W_int(d, CP, h) - W_ext(d, CP)

evaluated with batched einsums over (patch, element, qp, local basis).
Residuals and every Jacobian the reference builds by hand or via UFL
(`SVK_residual`, dR/du, dR/dCP, dR/dh_th; reference:
GOLDFISH/nonmatching_opt.py:433-452, 941-1015) are JAX derivatives of
this function. Newton/adjoint matrices come from exact per-element
Hessian blocks (vmapped `jax.hessian` of `element_energy`), which map to
batched small matmuls instead of FEniCS sparse assembly.

Shell model (Kiendl et al. 2009 isogeometric KL shell, the model behind
PENGoLINS' `SVK_residual`): membrane strain eps = (a_ab - A_ab)/2,
bending kappa = B_ab - b_ab, plane-stress SVK material in curvilinear
components:

    psi = h/2 * eps:H:eps + h^3/24 * kappa:H:kappa
    H^abgd = E/(1-nu^2) [nu A^ab A^gd + (1-nu)/2 (A^ag A^bd + A^ad A^bg)]
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goldfish_jax.geometry.patch_stack import PatchStack

__all__ = [
    "gather",
    "surface_fields",
    "element_energy",
    "internal_energy",
    "element_hessians",
    "external_work_dead_load",
    "volume",
    "qp_stress_vm",
]


def gather(cp, conn):
    """cp: (P, C, k), conn: (P, E, L) -> (P, E, L, k)."""
    return jax.vmap(lambda c, idx: c[idx])(cp, conn)


def _contract(R, vals):
    """R: (P,E,Q,L), vals: (P,E,L,k) -> (P,E,Q,k)."""
    return jnp.einsum("peql,pelk->peqk", R, vals)


def surface_fields(stack: PatchStack, coefs):
    """First/second parametric derivatives of a (P, C, k) coefficient
    field at all quadrature points: dict of (P, E, Q, k)."""
    ce = gather(coefs, stack.conn)
    return {
        "v": _contract(stack.R00, ce),
        "du": _contract(stack.R10, ce),
        "dv": _contract(stack.R01, ce),
        "duu": _contract(stack.R20, ce),
        "duv": _contract(stack.R11, ce),
        "dvv": _contract(stack.R02, ce),
    }


def _metric_pack(F):
    """Geometry pack at qps from a field dict F (the midsurface map)."""
    A1, A2 = F["du"], F["dv"]
    A3t = jnp.cross(A1, A2)
    J = jnp.linalg.norm(A3t, axis=-1)
    A3 = A3t / J[..., None]
    a11 = jnp.sum(A1 * A1, -1)
    a12 = jnp.sum(A1 * A2, -1)
    a22 = jnp.sum(A2 * A2, -1)
    b11 = jnp.sum(F["duu"] * A3, -1)
    b12 = jnp.sum(F["duv"] * A3, -1)
    b22 = jnp.sum(F["dvv"] * A3, -1)
    return dict(A1=A1, A2=A2, A3=A3, J=J,
                a=jnp.stack([a11, a12, a12, a22], -1).reshape(a11.shape + (2, 2)),
                b=jnp.stack([b11, b12, b12, b22], -1).reshape(b11.shape + (2, 2)))


def _inv2x2(M):
    det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    inv = jnp.stack(
        [M[..., 1, 1], -M[..., 0, 1], -M[..., 1, 0], M[..., 0, 0]], -1
    ).reshape(M.shape)
    return inv / det[..., None, None]


def _energy_quadratic(Aup, S, E, nu):
    """S:H:S per qp with H built from contravariant metric Aup."""
    tr = jnp.einsum("...ab,...ab->...", Aup, S)
    Sup = jnp.einsum("...ag,...gd,...db->...ab", Aup, S, Aup)
    full = jnp.einsum("...ab,...ab->...", Sup, S)
    return E / (1.0 - nu**2) * (nu * tr**2 + (1.0 - nu) * full)


def _qp_fields(R6, coef):
    """R6: 6-tuple of (Q, L); coef: (L, k) -> field dict of (Q, k)."""
    R00, R10, R01, R20, R11, R02 = R6
    f = lambda R: R @ coef
    return {"v": f(R00), "du": f(R10), "dv": f(R01),
            "duu": f(R20), "duv": f(R11), "dvv": f(R02)}


def qp_energy_density(Xf, uf, h_qp, E, nu):
    """KL-shell SVK energy density per quadrature point.

    Xf/uf: field dicts with (..., 3) leaves; h_qp: (...,); E, nu scalars
    or broadcastable. Returns (psi, J_ref)."""
    xf = {k: Xf[k] + uf[k] for k in Xf}
    ref = _metric_pack(Xf)
    cur = _metric_pack(xf)
    eps = 0.5 * (cur["a"] - ref["a"])
    kap = ref["b"] - cur["b"]
    Aup = _inv2x2(ref["a"])
    psi = 0.5 * h_qp * _energy_quadratic(Aup, eps, E, nu) \
        + (h_qp**3 / 24.0) * _energy_quadratic(Aup, kap, E, nu)
    return psi, ref["J"]


def element_energy(R6, de, pe, he, wq, E, nu):
    """Strain energy of one element from LOCAL gathered coefficients.

    R6: 6-tuple of (Q, L) basis tables; de, pe: (L, 3); he: (L,);
    wq: (Q,); E, nu scalars. This is the function whose vmapped
    `jax.hessian` yields the exact element stiffness blocks."""
    Xf = _qp_fields(R6, pe)
    uf = _qp_fields(R6, de)
    h_qp = _qp_fields(R6, he[:, None])["v"][:, 0]
    psi, J = qp_energy_density(Xf, uf, h_qp, E, nu)
    return jnp.sum(psi * J * wq)


def _stack_R6(stack: PatchStack):
    return (stack.R00, stack.R10, stack.R01,
            stack.R20, stack.R11, stack.R02)


def internal_energy(stack: PatchStack, d, cp, h_coef, E, nu):
    """Total SVK KL-shell strain energy.

    d, cp: (P, C, 3); h_coef: (P, C); E, nu: (P,). Returns scalar."""
    de = gather(d, stack.conn)
    pe = gather(cp, stack.conn)
    he = gather(h_coef[..., None], stack.conn)[..., 0]
    R6 = _stack_R6(stack)
    P, En, Q, L = stack.R00.shape

    def elem(R6e, dee, pee, hee, wqe, Ee, nue):
        return element_energy(R6e, dee, pee, hee, wqe, Ee, nue)

    v = jax.vmap(jax.vmap(elem, in_axes=(0, 0, 0, 0, 0, None, None)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0))
    Wpe = v(tuple(r for r in R6), de, pe, he, stack.wq, E, nu)
    return jnp.sum(Wpe)


def _element_hessians_ref(stack: PatchStack, d, cp, h_coef, E, nu,
                          pressure=None):
    """Reference implementation: vmapped jax.hessian over the 3L
    element dofs (kept as the oracle for element_hessians tests).
    With `pressure`, the element value is the POTENTIAL contribution
    (internal energy minus follower-pressure work)."""
    de = gather(d, stack.conn)
    pe = gather(cp, stack.conn)
    he = gather(h_coef[..., None], stack.conn)[..., 0]
    R6 = _stack_R6(stack)
    pr = jnp.zeros_like(E) if pressure is None else pressure

    def elem(R6e, dee, pee, hee, wqe, Ee, nue, pre):
        L = dee.shape[0]

        def f(dflat):
            dd = dflat.reshape(L, 3)
            W = element_energy(R6e, dd, pee, hee, wqe, Ee, nue)
            Xf = _qp_fields(R6e, pee)
            uf = _qp_fields(R6e, dd)
            x = Xf["v"] + uf["v"]
            xu = Xf["du"] + uf["du"]
            xv = Xf["dv"] + uf["dv"]
            vol_cur = jnp.sum(x * jnp.cross(xu, xv), -1)
            vol_ref = jnp.sum(Xf["v"] * jnp.cross(Xf["du"], Xf["dv"]),
                              -1)
            W_p = pre * jnp.sum((vol_cur - vol_ref) / 3.0 * wqe)
            return W - W_p

        return jax.hessian(f)(dee.reshape(-1))

    v = jax.vmap(jax.vmap(elem, in_axes=(0, 0, 0, 0, 0, None, None,
                                         None)),
                 in_axes=(0, 0, 0, 0, 0, 0, 0, 0))
    return v(tuple(r for r in R6), de, pe, he, stack.wq, E, nu, pr)


def element_hessians(stack: PatchStack, d, cp, h_coef, E, nu,
                     pressure=None):
    """Exact per-element POTENTIAL Hessian blocks: (P, E, 3L, 3L).

    Jet formulation: the energy density at a qp depends on d only
    through the displacement jet z (15 components (du, dv, duu, duv,
    dvv); 18 with the value jet when follower pressure contributes),
    so Ke = sum_q B_q^T H_q B_q with H_q the tiny qp Hessian (vmapped
    jax.hessian of a jet-var scalar) and B_q made of the basis tables.
    This turns the per-dof Hessian (3L = 48 forward passes per element)
    into tiny-jet Hessians + two einsums — ~5x cheaper than the
    dense jax.hessian path at bench scale.

    `pressure` (P,): FOLLOWER pressure contributes a d-dependent load
    stiffness -d^2 W_p/dd^2 that MUST be in the tangent — omitting it
    silently degrades adjoint gradients on pressurized models (round-2
    finding: 1.5% gradient error on the pressurized tube)."""
    P, En, Q, L = stack.R00.shape
    Xf = surface_fields(stack, cp)
    uf = surface_fields(stack, d)
    he = gather(h_coef[..., None], stack.conn)
    h_qp = _contract(stack.R00, he)[..., 0]             # (P, E, Q)
    with_p = pressure is not None
    keys = (("v",) if with_p else ()) + ("du", "dv", "duu", "duv",
                                         "dvv")
    nj = len(keys)
    Xz = jnp.stack([Xf[k] for k in keys], axis=-2)      # (P, E, Q, nj, 3)
    uz = jnp.stack([uf[k] for k in keys], axis=-2)
    pr = jnp.zeros_like(E) if pressure is None else pressure

    def qp_val(zflat, Xjet, hq, Ee, nue, pre, wq):
        z = zflat.reshape(nj, 3)
        zero = jnp.zeros(3, dtype=zflat.dtype)
        o = 1 if with_p else 0
        ufq = {"v": z[0] if with_p else zero,
               "du": z[o], "dv": z[o + 1],
               "duu": z[o + 2], "duv": z[o + 3], "dvv": z[o + 4]}
        Xfq = {"v": Xjet[0] if with_p else zero,
               "du": Xjet[o], "dv": Xjet[o + 1],
               "duu": Xjet[o + 2], "duv": Xjet[o + 3],
               "dvv": Xjet[o + 4]}
        psi, J = qp_energy_density(Xfq, ufq, hq, Ee, nue)
        val = psi * J
        if with_p:
            x = Xfq["v"] + ufq["v"]
            xu = Xfq["du"] + ufq["du"]
            xv = Xfq["dv"] + ufq["dv"]
            vol_cur = jnp.sum(x * jnp.cross(xu, xv))
            vol_ref = jnp.sum(Xfq["v"] * jnp.cross(Xfq["du"],
                                                   Xfq["dv"]))
            val = val - pre * (vol_cur - vol_ref) / 3.0
        return val * wq

    # Structured qp Hessian (ROADMAP perf item 1): the second-jet vars
    # s = (duu, duv, dvv) enter the energy ONLY linearly through the
    # normal components c_k = (X_ab + s_ab).n (bending curvature; the
    # membrane/pressure terms and the metric pack use first-jet vars m
    # only), so H_ss = Hc (x) n n^T with Hc the tiny 3x3 curvature-form
    # Hessian — no AD passes over s needed. Only the nm first-jet
    # columns [H_mm; H_sm] are taken by forward-over-reverse AD:
    # nm = 6 (9 with follower pressure) passes instead of 3*nj = 15
    # (18). Validated against the dense jax.hessian oracle
    # (_element_hessians_ref) in tests/test_klshell.py.
    nm = 3 * (3 if with_p else 2)

    def qp_hess(zflat, Xjet, hq, Ee, nue, pre, wq):
        g = lambda zz: jax.grad(qp_val)(zz, Xjet, hq, Ee, nue, pre, wq)
        tangents = jnp.eye(3 * nj, dtype=zflat.dtype)[:nm]
        Hm = jax.vmap(
            lambda t: jax.jvp(g, (zflat,), (t,))[1])(tangents)

        # analytic ss block at the CURRENT state
        z = zflat.reshape(nj, 3)
        o = 1 if with_p else 0
        xu = Xjet[o] + z[o]
        xv = Xjet[o + 1] + z[o + 1]
        nvec = jnp.cross(xu, xv)
        nvec = nvec / jnp.linalg.norm(nvec)
        Au, Av = Xjet[o], Xjet[o + 1]
        A3t = jnp.cross(Au, Av)
        Jref = jnp.linalg.norm(A3t)
        A3 = A3t / Jref
        a = jnp.array([[Au @ Au, Au @ Av], [Au @ Av, Av @ Av]])
        Aup = _inv2x2(a)
        refb = jnp.array(
            [[Xjet[o + 2] @ A3, Xjet[o + 3] @ A3],
             [Xjet[o + 3] @ A3, Xjet[o + 4] @ A3]])
        xb_n = jnp.array([Xjet[o + 2] @ nvec, Xjet[o + 3] @ nvec,
                          Xjet[o + 4] @ nvec])

        def val_c(c):
            cur_b = jnp.array([[xb_n[0] + c[0], xb_n[1] + c[1]],
                               [xb_n[1] + c[1], xb_n[2] + c[2]]])
            kap = refb - cur_b
            return (hq**3 / 24.0) * _energy_quadratic(
                Aup, kap, Ee, nue) * Jref * wq

        Hc = jax.hessian(val_c)(jnp.zeros(3, dtype=zflat.dtype))
        Hss = (Hc[:, None, :, None] * nvec[None, :, None, None]
               * nvec[None, None, None, :]).reshape(9, 9)

        H = jnp.zeros((3 * nj, 3 * nj), dtype=zflat.dtype)
        H = H.at[:nm, :].set(Hm)
        H = H.at[nm:, :nm].set(Hm[:, nm:].T)
        H = H.at[nm:, nm:].set(Hss)
        return H

    v = jax.vmap(jax.vmap(jax.vmap(
        qp_hess, in_axes=(0, 0, 0, None, None, None, 0)),
        in_axes=(0, 0, 0, None, None, None, 0)),
        in_axes=(0, 0, 0, 0, 0, 0, 0))
    H = v(uz.reshape(P, En, Q, 3 * nj), Xz, h_qp, E, nu, pr, stack.wq)
    H = H.reshape(P, En, Q, nj, 3, nj, 3)

    tabs = ((stack.R00,) if with_p else ()) + (
        stack.R10, stack.R01, stack.R20, stack.R11, stack.R02)
    Rs = jnp.stack(tabs, axis=-2)                  # (P, E, Q, nj, L)
    tmp = jnp.einsum("peqjxky,peqkm->peqjxmy", H, Rs)
    Ke = jnp.einsum("peqjxmy,peqjl->pelxmy", tmp, Rs)
    return Ke.reshape(P, En, 3 * L, 3 * L)


def external_work_dead_load(stack: PatchStack, d, cp, f_areal):
    """W_ext = sum_patches int f . u dA_ref  (dead areal load, f: (P, 3))."""
    X = surface_fields(stack, cp)
    u = surface_fields(stack, d)
    J = jnp.linalg.norm(jnp.cross(X["du"], X["dv"]), axis=-1)
    fu = jnp.einsum("pk,peqk->peq", f_areal, u["v"])
    return jnp.sum(fu * J * stack.wq)


def volume(stack: PatchStack, cp, h_coef):
    """Material volume: sum int h dA (reference:
    GOLDFISH/operations/volume_exop.py:21-27)."""
    X = surface_fields(stack, cp)
    J = jnp.linalg.norm(jnp.cross(X["du"], X["dv"]), axis=-1)
    he = gather(h_coef[..., None], stack.conn)
    h = _contract(stack.R00, he)[..., 0]
    return jnp.sum(h * J * stack.wq)


def qp_stress_vm(stack: PatchStack, d, cp, h_coef, E, nu, through: str = "top"):
    """Von Mises stress at quadrature points (plane stress, SVK).

    through: 'top' (z=+h/2), 'bottom' (-h/2) or 'mid' (0). Returns
    (P, E, Q) stresses in a local Cartesian surface frame, matching the
    role of ShNAPr ShellStressSVK.vonMisesStress (reference:
    GOLDFISH/operations/max_vmstress_exop.py:20-44).
    """
    X = surface_fields(stack, cp)
    u = surface_fields(stack, d)
    x = {k: X[k] + u[k] for k in X}
    ref = _metric_pack(X)
    cur = _metric_pack(x)
    eps = 0.5 * (cur["a"] - ref["a"])
    kap = ref["b"] - cur["b"]
    Aup = _inv2x2(ref["a"])
    he = gather(h_coef[..., None], stack.conn)
    h = _contract(stack.R00, he)[..., 0]
    z = {"top": 0.5, "mid": 0.0, "bottom": -0.5}[through] * h
    strain = eps + z[..., None, None] * kap

    Ep = E[:, None, None]
    nup = nu[:, None, None]
    coef = Ep / (1.0 - nup**2)
    tr = jnp.einsum("...ab,...ab->...", Aup, strain)
    Sup = coef[..., None, None] * (
        nup[..., None, None] * tr[..., None, None] * Aup
        + (1 - nup[..., None, None])
        * jnp.einsum("...ag,...gd,...db->...ab", Aup, strain, Aup)
    )
    A1, A2 = ref["A1"], ref["A2"]
    e1 = A1 / jnp.linalg.norm(A1, axis=-1, keepdims=True)
    A2p = A2 - jnp.sum(A2 * e1, -1, keepdims=True) * e1
    e2 = A2p / jnp.linalg.norm(A2p, axis=-1, keepdims=True)
    T = jnp.stack(
        [jnp.stack([jnp.sum(A1 * e1, -1), jnp.sum(A1 * e2, -1)], -1),
         jnp.stack([jnp.sum(A2 * e1, -1), jnp.sum(A2 * e2, -1)], -1)], -2
    )  # (..., a, i)
    sig = jnp.einsum("...ab,...ai,...bj->...ij", Sup, T, T)
    s11, s22, s12 = sig[..., 0, 0], sig[..., 1, 1], sig[..., 0, 1]
    return jnp.sqrt(jnp.maximum(s11**2 + s22**2 - s11 * s22 + 3 * s12**2, 0.0))
