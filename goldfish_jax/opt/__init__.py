from goldfish_jax.opt.problem import OptProblem, OptResult  # noqa: F401
from goldfish_jax.opt.warmstart import SecantWarmStart  # noqa: F401
