"""Crisfield arc-length (Riks) continuation for limit-point paths.

Traces the equilibrium path R(d, lam) = r_int(d) - lam * f_ext = 0
THROUGH limit points (snap-through/snap-back), where load-controlled
Newton — the reference's only nonlinear strategy (PENGoLINS
`solve_nonlinear_nonmatching_problem`; reference role:
GOLDFISH/utils/opt_utils.py:135-154 `Newton_solve`) — jumps or
diverges. Augments the unknowns with the load factor lam and replaces
the load ramp by the cylindrical arc constraint

    |d - d_n|^2 + psi^2 (lam - lam_n)^2 |q|^2 = dl^2 ,

solving the bordered system with two tangent solves per iteration
(K \\ R and K \\ q, the classic Crisfield 1981 scheme) and picking the
quadratic root that keeps moving along the path. Load magnitudes
follow `scale_loads`, so every load type (point/edge/areal/pressure/
field) participates; q = -dR/dlam is computed by AD, which keeps
follower pressure exact.

Host-side loop over jitted kernels (CPU path; arc-length solves are
preparation/robustness tools, not the optimizer hot loop).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from goldfish_jax.solver.linalg import linear_solve
from goldfish_jax.solver.system import (
    SystemData,
    assemble_K,
    residual,
    scale_loads,
)

__all__ = ["riks_solve"]


@partial(jax.jit, static_argnames=())
def _R_q(data: SystemData, cp, h, d, lam):
    """Residual at load factor lam and q = -dR/dlam (AD through the
    load scaling — exact for follower loads too)."""
    def Rfun(l):
        return residual(scale_loads(data, l), d, cp, h)

    R, dRdlam = jax.jvp(Rfun, (lam,), (jnp.ones_like(lam),))
    return R, -dRdlam


@jax.jit
def _tangent_solves(data: SystemData, cp, h, d, lam, R, q):
    """One factorization, two solves: dd_r = -K \\ R, dd_q = K \\ q."""
    K = assemble_K(scale_loads(data, lam), d, cp, h)
    free = data.free
    rhs = jnp.stack([(-R * free).reshape(-1), (q * free).reshape(-1)],
                    axis=1)
    sol = linear_solve(K, rhs)
    dd_r = sol[:, 0].reshape(d.shape) * free
    dd_q = sol[:, 1].reshape(d.shape) * free
    return dd_r, dd_q


def _arc_root(Dd, Dlam, dd_r, dd_q, q2, dl, psi):
    """delta-lam from the cylindrical constraint: the root of
    a x^2 + b x + c closest to continuing along the current increment."""
    t = Dd + dd_r
    # one batched readback (sequential float() fetches sync the host
    # once each)
    qq, tq, tt, ddt, ddq = (float(v) for v in jax.device_get(
        (jnp.vdot(dd_q, dd_q), jnp.vdot(t, dd_q), jnp.vdot(t, t),
         jnp.vdot(Dd, t), jnp.vdot(Dd, dd_q))))
    a = qq + psi**2 * q2
    b = 2.0 * (tq + psi**2 * Dlam * q2)
    c = tt + psi**2 * Dlam**2 * q2 - dl**2
    disc = b * b - 4.0 * a * c
    if disc < 0.0 or a <= 0.0:
        return None  # arc too small for this correction: cut dl
    s = disc ** 0.5
    x1 = (-b + s) / (2.0 * a)
    x2 = (-b - s) / (2.0 * a)
    # continue forward: maximize alignment of the new increment with
    # the old one (Crisfield's angle criterion)
    def align(x):
        return ddt + x * ddq + psi**2 * q2 * Dlam * (Dlam + x)

    return x1 if align(x1) >= align(x2) else x2


def riks_solve(data: SystemData, cp, h, d0, lam0=0.0, lam_target=1.0,
               dlam0=0.1, rtol=1e-8, max_it=20, max_steps=200,
               psi=1.0, dl_max=None, verbose=False):
    """Trace the equilibrium path from (d0, lam0) toward lam_target.

    Returns (d, lam, path) where path is a list of (lam, |d|_2)
    pairs per converged point; the final
    (d, lam) is the last converged state — lam == lam_target when the
    path reaches it (a closing load-controlled Newton polishes the
    final point), else the furthest traced point.
    """
    d = d0
    lam = jnp.asarray(lam0, dtype=d0.dtype)

    R, q = _R_q(data, cp, h, d, lam)
    q2 = float(jnp.vdot(q, q))
    r_ref = max(float(jnp.linalg.norm(q)), 1e-300)

    # initial increment: load-controlled predictor of size dlam0
    dd_r, dd_q = _tangent_solves(data, cp, h, d, lam, R, q)
    dl = max(float(jnp.linalg.norm(dlam0 * dd_q)), 1e-12)
    Dd_prev = dlam0 * dd_q
    Dlam_prev = dlam0

    path = [(float(lam), float(jnp.linalg.norm(d)))]
    it_hist = []

    for step in range(max_steps):
        # ---- predictor along the previous increment ----------------
        R, q = _R_q(data, cp, h, d, lam)
        dd_r, dd_q = _tangent_solves(data, cp, h, d, lam, R, q)
        q2, nq, dirn = (float(v) for v in jax.device_get(
            (jnp.vdot(q, q), jnp.linalg.norm(dd_q),
             jnp.vdot(Dd_prev, dd_q))))
        denom = nq ** 2 + psi**2 * q2
        Dlam = dl / denom ** 0.5
        # direction: continue the way we were going
        if dirn + psi**2 * Dlam_prev * q2 < 0:
            Dlam = -Dlam
        Dd = Dlam * dd_q
        d_trial = d + Dd
        lam_trial = lam + Dlam

        # ---- corrector --------------------------------------------
        ok = False
        for it in range(max_it):
            R, q = _R_q(data, cp, h, d_trial, lam_trial)
            rn, q2 = (float(v) for v in jax.device_get(
                (jnp.linalg.norm(R * data.free), jnp.vdot(q, q))))
            if rn <= rtol * r_ref:
                ok = True
                break
            dd_r, dd_q = _tangent_solves(data, cp, h, d_trial,
                                         lam_trial, R, q)
            dlam_c = _arc_root(Dd, Dlam, dd_r, dd_q, q2, dl, psi)
            if dlam_c is None:
                break
            Dd = Dd + dd_r + dlam_c * dd_q
            Dlam = Dlam + dlam_c
            d_trial = d + Dd
            lam_trial = lam + Dlam

        if not ok:
            dl *= 0.5
            if dl < 1e-14:
                break
            continue

        d = d_trial
        lam = lam_trial
        Dd_prev, Dlam_prev = Dd, Dlam
        path.append((float(lam), float(jnp.linalg.norm(d))))
        it_hist.append(it)
        if verbose:
            print(f"  riks step {step}: lam={float(lam):+.5f} "
                  f"|d|={float(jnp.linalg.norm(d)):.4e} its={it} "
                  f"dl={dl:.3e}", flush=True)

        # adaptive arc: target ~5 corrector iterations
        dl *= min(2.0, max(0.5, (5.0 / max(it, 1)) ** 0.5))
        if dl_max is not None:
            dl = min(dl, dl_max)

        if float(lam) >= lam_target:
            # polish at exactly lam_target with load-controlled Newton
            from goldfish_jax.solver.implicit import newton_solve

            d, _, _ = newton_solve(scale_loads(data, lam_target), cp, h,
                                   d, rtol=rtol)
            lam = jnp.asarray(lam_target, dtype=d0.dtype)
            path.append((float(lam), float(jnp.linalg.norm(d))))
            break

    return d, float(lam), path
