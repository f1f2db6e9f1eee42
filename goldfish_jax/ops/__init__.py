from goldfish_jax.ops import bspline, quadrature, refine  # noqa: F401
