"""Crisfield arc-length continuation (solver/riks.py): trace the
shallow-cylindrical-panel snap-through (Sze/Crisfield benchmark
family) THROUGH its limit point — the regime where the reference's
load-controlled Newton (GOLDFISH/utils/opt_utils.py:135-154) jumps.
"""
import jax.numpy as jnp
import numpy as np

from goldfish_jax.geometry.cadkit import circle, extrude
from goldfish_jax.solver.riks import riks_solve
from goldfish_jax.solver.system import NonMatchingSystem, residual, scale_loads


def _panel(num_el=6, p=2):
    R, L, th = 2540.0, 508.0, 0.1
    arc = circle(radius=R, angle=(np.pi / 2 - th, np.pi / 2 + th))
    surf = extrude(arc, (0.0, 0.0, L)).elevate(0, p - 2).elevate(1, p - 1)
    kn = np.linspace(0, 1, num_el + 1)[1:-1]
    surf = surf.refine(0, kn).refine(1, kn)
    s = NonMatchingSystem([surf], 3102.75, 0.3, 12.7)
    s.add_side_bc(0, direction=0, side=0, n_layers=1)   # hinged
    s.add_side_bc(0, direction=0, side=1, n_layers=1)
    s.add_point_load(0, [0.5, 0.5], [0.0, -4000.0, 0.0])
    return s


def test_riks_traces_snap_through():
    s = _panel()
    d0 = s.zero_displacement()
    d, lam, path = riks_solve(s.data, s.cp, s.h_init, d0,
                              lam_target=1.0, dlam0=0.02, rtol=1e-6,
                              dl_max=60.0, max_steps=150)
    lams = np.array([p[0] for p in path])
    norms = np.array([p[1] for p in path])

    # reached the target load exactly, at equilibrium
    assert lam == 1.0
    rn = float(jnp.linalg.norm(
        residual(scale_loads(s.data, 1.0), d, s.cp, s.h_init)
        * s.data.free))
    q0 = float(jnp.linalg.norm(
        residual(scale_loads(s.data, 1.0), d0, s.cp, s.h_init)
        * s.data.free))
    assert rn < 1e-5 * q0

    # the path TRACES the limit point: lam rises, then DESCENDS along
    # the unstable branch (load-controlled Newton cannot produce a
    # decreasing-lam equilibrium sequence), then rises to the target
    i_peak = int(np.argmax(lams[: len(lams) // 2]))
    lam_peak = lams[i_peak]
    lam_valley = lams[i_peak:].min()
    assert lam_peak > lam_valley + 0.2, (lam_peak, lam_valley)
    assert lams[-1] == 1.0

    # snap-through: displacement at the target far exceeds the
    # pre-limit displacement at comparable load
    pre = norms[: i_peak + 1].max()
    assert norms[-1] > 3.0 * pre
