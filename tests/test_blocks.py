"""Block-operator tangent path (solver/blocks.py) vs the dense system,
and the mixed-mode Newton/adjoint built on it (forced on CPU)."""

import jax.numpy as jnp
import numpy as np

from goldfish_jax.models import plate
from goldfish_jax.solver import linalg
from goldfish_jax.solver.blocks import (
    block_gmres_solve,
    block_matvec,
    compute_blocks,
    dense_f32_from_blocks,
)
from goldfish_jax.solver.system import assemble_K


def _sys():
    return plate.build(num_el=3, p=2, num_patches=3)


def test_block_matvec_matches_dense():
    sys = _sys()
    d = sys.zero_displacement()
    blocks = compute_blocks(sys.data, d, sys.cp, sys.h_init)
    K = np.asarray(assemble_K(sys.data, d, sys.cp, sys.h_init))
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=np.asarray(d).shape))
    mv = block_matvec(sys.data, blocks, v)
    ref = (K @ np.asarray(v).reshape(-1)).reshape(np.asarray(v).shape)
    err = np.abs(np.asarray(mv) - ref).max() / np.abs(ref).max()
    assert err < 1e-13, err


def test_dense_f32_matches():
    sys = _sys()
    d = sys.zero_displacement()
    blocks = compute_blocks(sys.data, d, sys.cp, sys.h_init)
    K32 = np.asarray(dense_f32_from_blocks(sys.data, blocks))
    K = np.asarray(assemble_K(sys.data, d, sys.cp, sys.h_init))
    rel = np.abs(K32 - K).max() / np.abs(K).max()
    assert rel < 1e-6, rel


def test_block_gmres_solves_exactly():
    sys = _sys()
    d = sys.zero_displacement()
    blocks = compute_blocks(sys.data, d, sys.cp, sys.h_init)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=np.asarray(d).shape)) * sys.data.free
    x = block_gmres_solve(sys.data, blocks, b, tol=1e-12, n_ir=3)
    res = block_matvec(sys.data, blocks, x) - b
    rel = float(jnp.linalg.norm(res) / jnp.linalg.norm(b))
    assert rel < 1e-7, rel


def test_mixed_mode_gradient_parity():
    """Force the mixed path on CPU: Newton + adjoint through
    the block operator must match 1e-6 FD parity."""
    import jax

    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    linalg.set_mode("mixed")
    try:
        sys = _sys()
        solve = build_solve_fn(sys.data, rtol=1e-10, max_it=25)
        d0 = sys.zero_displacement()

        def J(h):
            dd = solve(sys.cp, h, d0)
            return kl_shell.internal_energy(sys.stack, dd, sys.cp, h,
                                            sys.E, sys.nu)

        g = jax.grad(J)(sys.h_init)
        rng = np.random.default_rng(2)
        v = jnp.asarray(rng.normal(size=np.asarray(sys.h_init).shape)
                        * np.asarray(sys.stack.cp_mask))
        eps = 1e-5
        fd = (J(sys.h_init + eps * v) - J(sys.h_init - eps * v)) / (2 * eps)
        ad = jnp.sum(g * v)
        assert abs(float(ad - fd)) / abs(float(fd)) < 1e-5, (
            float(ad), float(fd))
    finally:
        linalg.set_mode(None)
