"""Template for user-defined explicit operations.

Mirror of the reference's `custom_exop.py` (reference:
GOLDFISH/operations/custom_exop.py — a skeleton users copy to add
their own objective/constraint with hand-coded partials). In this
build a custom operation is just a differentiable function of
(data, d, cp, h); the base class wires the flat-vector adapter surface
and ALL partials via jax.grad — nothing to derive by hand.

Example::

    from goldfish_jax.operations.custom_exop import CustomExOperation

    def tip_deflection(data, d, cp, h):
        # any jnp expression of the padded state/design arrays
        return d[0, -1, 2]

    op = CustomExOperation(system, tip_deflection)
    val = op.compute(cp_flat, h_flat, d_flat)
    d_cp, d_h, d_d = op.gradients(cp_flat, h_flat, d_flat)
"""

from __future__ import annotations

from goldfish_jax.operations.exops import _ExOpBase

__all__ = ["CustomExOperation"]


class CustomExOperation(_ExOpBase):
    """fn(data, d, cp, h) -> scalar; partials come from AD."""

    def __init__(self, system, fn):
        super().__init__(system, fn)
