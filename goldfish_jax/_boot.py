"""Pre-backend distributed bootstrap.

`jax.distributed.initialize` must run BEFORE any JAX call that
initializes the XLA backend — and importing `goldfish_jax` builds
module-level jnp tables, which does exactly that. The package root
therefore calls `init_distributed_from_env()` FIRST, before importing
any submodule, so a configured cluster process (GOLDFISH_*/JAX_* env
vars set by the launcher) comes up with the GLOBAL device world no
matter what the application imports afterwards. Discovered by the real
2-process test (tests/test_multichip.py): the previous call-it-later
API raised "initialize() must be called before any JAX calls" on every
realistic import order.

This module must stay import-light: no jax import at module level, no
goldfish_jax imports at all.

Reference role: the multi-rank MPI world the rebuild replaces
(GOLDFISH/utils/opt_utils.py:28-54, nonmatching_opt.py:719-723).
"""

from __future__ import annotations

import os

_initialized = False


def _pick(explicit, env, *keys):
    if explicit is not None:
        return explicit
    for k in keys:
        v = env.get(k)
        if v not in (None, ""):
            return v
    return None


def init_distributed_from_env(coordinator=None, num_processes=None,
                              process_id=None, env=None) -> bool:
    """Idempotent guarded `jax.distributed.initialize`.

    Returns True when this process is part of a configured multi-process
    cluster (initializing on the first call), False when unconfigured or
    single-process. Env vars (first match wins):
      coordinator: GOLDFISH_COORDINATOR, JAX_COORDINATOR_ADDRESS
      num_processes: GOLDFISH_NUM_PROCESSES, JAX_NUM_PROCESSES
      process_id: GOLDFISH_PROCESS_ID, JAX_PROCESS_ID
    """
    global _initialized
    env = os.environ if env is None else env
    coord = _pick(coordinator, env, "GOLDFISH_COORDINATOR",
                  "JAX_COORDINATOR_ADDRESS")
    n = _pick(num_processes, env, "GOLDFISH_NUM_PROCESSES",
              "JAX_NUM_PROCESSES")
    pid = _pick(process_id, env, "GOLDFISH_PROCESS_ID", "JAX_PROCESS_ID")
    if coord is None or n is None or int(n) <= 1:
        return False
    if _initialized:
        return True
    import jax

    jax.distributed.initialize(coordinator_address=str(coord),
                               num_processes=int(n),
                               process_id=int(pid or 0))
    _initialized = True
    return True
