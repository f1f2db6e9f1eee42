from goldfish_jax.solver.system import NonMatchingSystem, SystemData  # noqa: F401
