"""goldfish_jax: isogeometric Kirchhoff-Love shell optimization in JAX.

A ground-up JAX/XLA rebuild of the capabilities of hanzhao2020/GOLDFISH
(Gradient-based Optimization and Large-scale Design Framework for
Isogeometric SHells): shape and thickness optimization of Kirchhoff-Love
shell structures built from multiple non-matching NURBS/B-spline
patches, with analytic adjoint sensitivities — including moving
patch-patch intersections.

Architecture (vs. the reference's FEniCS/PETSc/OCC/MPI stack):

  - NURBS basis tables + per-quadrature-point SVK shell energy are
    batched JAX computations (padded/stacked over patches);
    a traced Cox-de-Boor evaluator powers the moving-intersection path.
  - Residuals and every Jacobian/adjoint (dR/du, dR/dCP, dR/dh, dR/dxi)
    are JAX AD of ONE scalar total-potential functional — replacing UFL
    `derivative` + ~1500 lines of hand-built matrix calculus
    (reference: GOLDFISH/nonmatching_opt.py:941-1341).
  - Linear algebra is a native f64 dense factorization inside one
    jitted Newton loop (LAPACK on the CPU, cuSOLVER on an NVIDIA GPU) —
    the MUMPS replacement; large models use matrix-free Newton-Krylov
    with a colored multiplicative pair-Schwarz preconditioner.
  - MPI patch distribution becomes jax.sharding over a device Mesh.
  - Host-side CAD (IGES import, surface-surface intersections) is
    OCC-free: a C++ geometry kernel (native/) with a numpy fallback.
  - Thin OpenMDAO / CSDL adapter layers preserve the reference's
    component APIs (optional dependencies).
"""

__version__ = "0.1.0"

# Distributed boot MUST precede every other goldfish import: submodules
# build jnp tables at import time, which initializes the XLA backend,
# after which jax.distributed.initialize is rejected. A configured
# cluster process (GOLDFISH_COORDINATOR/... env vars) therefore joins
# the global device world here; unconfigured processes no-op.
from goldfish_jax._boot import init_distributed_from_env as _boot_dist

_boot_dist()

from goldfish_jax import config  # noqa: F401,E402
from goldfish_jax.geometry import cadkit  # noqa: F401
from goldfish_jax.geometry.nurbs import NURBS  # noqa: F401
from goldfish_jax.ops import bspline, quadrature, refine  # noqa: F401
from goldfish_jax.physics import coupling, kl_shell, loads  # noqa: F401
from goldfish_jax.solver.system import (  # noqa: F401
    NonMatchingSystem,
    SystemData,
)

__all__ = ["config", "NURBS", "NonMatchingSystem", "SystemData",
           "__version__"]
