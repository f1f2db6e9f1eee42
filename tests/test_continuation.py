"""Load-stepped Newton (solver/implicit.continuation_solve)."""

import jax.numpy as jnp
import numpy as np

from goldfish_jax.models import plate
from goldfish_jax.solver.implicit import continuation_solve, newton_solve
from goldfish_jax.solver.system import residual


def test_continuation_matches_direct_solve():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d1, _, _ = newton_solve(sys.data, sys.cp, sys.h_init,
                            sys.zero_displacement(), rtol=1e-11)
    d2, it, rn = continuation_solve(sys.data, sys.cp, sys.h_init,
                                    sys.zero_displacement(), n_steps=4,
                                    rtol=1e-11)
    # both solves bottom out at the conditioning noise floor (~1e-6)
    err = float(jnp.linalg.norm(d1 - d2) / jnp.linalg.norm(d1))
    assert err < 1e-5, err
    r_ref = float(jnp.linalg.norm(residual(
        sys.data, sys.zero_displacement(), sys.cp, sys.h_init)))
    assert float(rn) < 1e-7 * r_ref
