"""Matrix-free Newton-Krylov vs the dense-direct path."""

import jax.numpy as jnp
import numpy as np

from goldfish_jax.models import plate
from goldfish_jax.solver.implicit import newton_solve
from goldfish_jax.solver.krylov import (
    PairSchwarz,
    gmres_solve,
    newton_krylov_solve,
    patch_block_precond,
)
from goldfish_jax.solver.system import assemble_K, tangent_matvec


def test_tangent_matvec_matches_dense():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d = sys.zero_displacement()
    K = np.asarray(assemble_K(sys.data, d, sys.cp, sys.h_init))
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=d.shape)) * sys.data.free
    mv = tangent_matvec(sys.data, d, sys.cp, sys.h_init, v)
    ref = (K @ np.asarray(v).reshape(-1)).reshape(v.shape)
    # dense path puts 1s on fixed diag; matvec zeroes them; mask both
    ref = ref * np.asarray(sys.data.free)
    err = np.linalg.norm(np.asarray(mv) - ref) / np.linalg.norm(ref)
    assert err < 1e-12, err


def test_gmres_matches_direct():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d = sys.zero_displacement()
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=d.shape)) * sys.data.free
    ps = PairSchwarz(sys.data)
    fac = ps.assemble(sys.data, d, sys.cp, sys.h_init)
    x, it = gmres_solve(sys.data, d, sys.cp, sys.h_init, b, (ps, fac),
                        rtol=1e-12, restart=40, maxiter=50)
    Kx = tangent_matvec(sys.data, d, sys.cp, sys.h_init, x)
    res = float(jnp.linalg.norm(Kx - b) / jnp.linalg.norm(b))
    assert res < 1e-8, res


def test_newton_krylov_matches_dense_newton():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d_dense, _, _ = newton_solve(sys.data, sys.cp, sys.h_init,
                                 sys.zero_displacement(), rtol=1e-11)
    d_mf, it, rn = newton_krylov_solve(sys.data, sys.cp, sys.h_init,
                                       sys.zero_displacement(), rtol=1e-9,
                                       cg_rtol=1e-8)
    # compare physically: tip displacement agreement (dof-wise error is
    # cond-amplified and not meaningful between two converged solves)
    err = float(jnp.linalg.norm(d_mf - d_dense)
                / jnp.linalg.norm(d_dense))
    assert err < 1e-4, (err, int(it), float(rn))
