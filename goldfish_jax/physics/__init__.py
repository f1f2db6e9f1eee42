from goldfish_jax.physics import kl_shell, coupling, loads  # noqa: F401
