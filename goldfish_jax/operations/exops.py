"""Explicit operations: objectives with their partials, adapter-ready.

Mirrors the reference's explicit-operation protocol (`compute` +
per-input gradients; reference: GOLDFISH/operations/int_energy_exop.py
:61-107, volume_exop.py:52-84, compliance_exop.py,
max_vmstress_exop.py:333-) over flat real-dof numpy vectors. Every
gradient is one jitted jax.grad — the reference's per-input
hand-assembled UFL derivative forms are gone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.physics import objectives
from goldfish_jax.solver.system import NonMatchingSystem

__all__ = ["IntEnergyExOperation", "VolumeExOperation",
           "ComplianceExOperation", "MaxvMStressExOperation",
           "VMStressExOperation", "IntEnergyReguExOperation"]


class _ExOpBase:
    """Shared machinery: flat <-> padded conversion + jitted grads.

    `data` and any op-specific arrays (`extra`) flow through jit
    ARGUMENTS, so the compiled programs do not embed them."""

    def __init__(self, system: NonMatchingSystem, fn, extra=()):
        self.system = system
        self.data = system.data
        self.layout = CPLayout(system.metas, system.stack.max_cp)
        self._extra = tuple(jnp.asarray(e) for e in extra)
        lay = self.layout

        def flat_fn(data, extra, cp_f, h_f, d_f):
            cp = lay.to_padded(cp_f.reshape(-1, 3))
            h = lay.to_padded(h_f)
            d = lay.to_padded(d_f.reshape(-1, 3))
            return fn(data, d, cp, h, *extra)

        self._value = jax.jit(flat_fn)
        self._grads = jax.jit(jax.grad(flat_fn, argnums=(2, 3, 4)))

    def compute(self, cp, h, d):
        return float(self._value(self.data, self._extra,
                                 jnp.asarray(cp), jnp.asarray(h),
                                 jnp.asarray(d)))

    def gradients(self, cp, h, d):
        """(dJ/dcp, dJ/dh, dJ/dd) as flat numpy arrays."""
        g = self._grads(self.data, self._extra, jnp.asarray(cp),
                        jnp.asarray(h), jnp.asarray(d))
        return tuple(np.asarray(x) for x in g)


class IntEnergyExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.internal_energy(data, d, cp, h))


class VolumeExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.volume(data, cp, h))


class ComplianceExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.compliance(data, d, cp, h))


class MaxvMStressExOperation(_ExOpBase):
    def __init__(self, system, rho=100.0, method="KS", through="top"):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.max_vm_stress(data, d, cp, h, rho=rho,
                                                  method=method,
                                                  through=through))


class IntEnergyReguExOperation(_ExOpBase):
    """W_int + per-patch CP-smoothness regularization (the reference
    eVTOL driver's objective, reference: demos_om/shape_opt/eVTOL/
    int_energy_regu_exop.py:1-; the regularization reference state is
    the system's initial control net)."""

    def __init__(self, system, regu_para=1.0, field=2, h_regu=1e-3):
        super().__init__(
            system,
            lambda data, d, cp, h, cp_init:
            objectives.internal_energy_regu(
                data, d, cp, h, cp_init, regu_para,
                field=field, h_regu=h_regu),
            extra=(system.cp,))


class VMStressExOperation:
    """Per-quadrature-point von Mises stress FIELD (vector output).

    The reference returns per-patch stress vectors, not only the
    aggregated scalar (reference: GOLDFISH/csdl_models/vmstress_model.py
    :1-331); this operation exposes the same surface: compute() gives
    the stacked real-qp stress values, jacobians() the dense
    d(sigma)/d(cp, h, u) (jax.jacrev), and vjp() the adjoint product
    for matrix-free consumers.
    """

    def __init__(self, system: NonMatchingSystem, through: str = "top"):
        from goldfish_jax.physics import kl_shell

        self.system = system
        self.data = system.data
        self.layout = CPLayout(system.metas, system.stack.max_cp)
        lay = self.layout
        wq = np.asarray(system.stack.wq).reshape(-1)
        self._keep = jnp.asarray(np.nonzero(wq > 0)[0], dtype=jnp.int32)
        self.out_size = int(self._keep.size)

        def flat_fn(cp_f, h_f, d_f):
            cp = lay.to_padded(cp_f.reshape(-1, 3))
            h = lay.to_padded(h_f)
            d = lay.to_padded(d_f.reshape(-1, 3))
            s = kl_shell.qp_stress_vm(self.data.stack, d, cp, h,
                                      self.data.E, self.data.nu,
                                      through=through)
            return s.reshape(-1)[self._keep]

        self._value = jax.jit(flat_fn)
        self._jac = jax.jit(jax.jacrev(flat_fn, argnums=(0, 1, 2)))

        def _vjp(cp_f, h_f, d_f, ct):
            _, f = jax.vjp(flat_fn, cp_f, h_f, d_f)
            return f(ct)

        self._vjp = jax.jit(_vjp)

    def compute(self, cp, h, d):
        return np.asarray(self._value(jnp.asarray(cp), jnp.asarray(h),
                                      jnp.asarray(d)))

    def jacobians(self, cp, h, d):
        """(dS/dcp, dS/dh, dS/dd) dense — demo-scale sizes only."""
        J = self._jac(jnp.asarray(cp), jnp.asarray(h), jnp.asarray(d))
        return tuple(np.asarray(x) for x in J)

    def vjp(self, cp, h, d, ct):
        out = self._vjp(jnp.asarray(cp), jnp.asarray(h), jnp.asarray(d),
                        jnp.asarray(ct))
        return tuple(np.asarray(x) for x in out)
