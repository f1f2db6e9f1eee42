"""Design-variable pipelines: flat design vectors -> padded system arrays.

The reference threads design variables through chains of sparse-matrix
components (HthFFD2FEComp -> HthFE2IGAComp -> DispStatesComp etc.,
reference: demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:59-81).
Here the same maps are pure JAX functions built from constant dense
matrices: FFD basis evaluation (matmul) + index scatter into the
padded (P, C) arrays the physics consumes. No FE/IGA distinction
remains (SURVEY.md section 2.4 tIGAr row), so the whole chain is
design -> padded CP/thickness in one jittable map.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.ffd import FFDBlock, create_3D_block
from goldfish_jax.geometry.patch_stack import PatchMeta

__all__ = ["CPLayout", "ThicknessFFD", "PatchConstantThickness",
           "ShapeFFD", "MultiThicknessFFD", "MultiShapeFFD"]


class CPLayout:
    """Index maps between flat stacked CP vectors (all patches
    concatenated, real CPs only) and padded (P, C) device arrays."""

    def __init__(self, metas: list[PatchMeta], max_cp: int):
        self.n_per_patch = [m.n_cp for m in metas]
        self.offsets = np.cumsum([0] + self.n_per_patch)
        self.n_flat = int(self.offsets[-1])
        P = len(metas)
        idx = np.full((P, max_cp), self.n_flat, dtype=np.int64)
        for i, m in enumerate(metas):
            idx[i, : m.n_cp] = self.offsets[i] + np.arange(m.n_cp)
        self._idx = jnp.asarray(idx, dtype=jnp.int32)

    def to_padded(self, flat):
        """(n_flat, ...) -> (P, C, ...); padding entries become 0."""
        ext = jnp.concatenate(
            [flat, jnp.zeros((1,) + flat.shape[1:], dtype=flat.dtype)], axis=0)
        return ext[self._idx]

    def to_flat(self, padded):
        """(P, C, ...) -> (n_flat, ...), dropping padding."""
        P, C = padded.shape[:2]
        flat = padded.reshape((P * C,) + padded.shape[2:])
        keep = (np.asarray(self._idx).ravel() < self.n_flat)
        order = np.asarray(self._idx).ravel()[keep]
        inv = np.empty(self.n_flat, dtype=np.int64)
        inv[order] = np.nonzero(keep)[0]
        return flat[jnp.asarray(inv, dtype=jnp.int32)]


class ThicknessFFD:
    """h_ffd (n_ffd,) -> padded thickness coefficients (P, C).

    Reference: `set_thopt_FFD` + HthFFD2FE/HthFE2IGA chain
    (GOLDFISH/nonmatching_opt_ffd.py:434-532). The FFD block spans the
    surface CPs' bounding box (optionally expanded); initial h_ffd is
    the constant-thickness vector (linear precision makes the map exact
    for constants: partition of unity)."""

    def __init__(self, system, num_els=(2, 1, 1), p=2, lims=None,
                 surf_inds=None):
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp)
        pts = np.concatenate(
            [m.surf.points.reshape(-1, 3) for m in metas], axis=0)
        if lims is None:
            lo, hi = pts.min(0), pts.max(0)
            pad = 1e-6 * np.maximum(hi - lo, 1.0)
            lims = np.stack([lo - pad, hi + pad], axis=1)
        self.block = create_3D_block(num_els, p, lims)
        self.ffd = FFDBlock(self.block, pts)
        self.F = jnp.asarray(self.ffd.F)
        self.n_ffd = self.ffd.n_ffd
        self.shape = self.ffd.shape

    def init_h_ffd(self, h0: float) -> np.ndarray:
        return np.full(self.n_ffd, float(h0))

    def __call__(self, h_ffd):
        return self.layout.to_padded(self.F @ h_ffd)


class PatchConstantThickness:
    """h (n_patches,) -> padded thickness coefficients (P, C): one
    constant thickness per patch.

    The design map of the reference's const-thickness drivers — a
    block of ones per patch (GOLDFISH/om_comps/ffd_comps/
    hth_map_comp.py:48-56, used by demos_om/thickness_opt/pegasus/
    pegasus_const_th_opt_wint.py:46-56). Padded CP slots follow
    `CPLayout.to_padded`'s zero-padding convention (they carry zero
    quadrature weight)."""

    def __init__(self, system):
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp)
        reps = np.concatenate(
            [np.full(m.n_cp, i) for i, m in enumerate(metas)])
        self._patch_of = jnp.asarray(reps, dtype=jnp.int32)
        self.n = len(metas)

    def init_h(self, h0) -> np.ndarray:
        """Initial per-patch design vector (scalar or per-patch list,
        matching the reference's averaged init at
        pegasus_const_th_opt_wint.py:34-35)."""
        return np.broadcast_to(np.asarray(h0, dtype=float),
                               (self.n,)).copy()

    def __call__(self, h):
        return self.layout.to_padded(h[self._patch_of])


class ShapeFFD:
    """p_ffd (n_ffd, 3) -> padded control points (P, C, 3).

    Reference: `set_shopt_FFD` (GOLDFISH/nonmatching_opt_ffd.py:143-182)
    — surface CPs follow the FFD block coefficients linearly. Fields not
    in `opt_fields` stay at their initial values."""

    def __init__(self, system, num_els=(2, 2, 2), p=2, lims=None,
                 opt_fields=(0, 1, 2)):
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp)
        pts = np.concatenate(
            [m.surf.points.reshape(-1, 3) for m in metas], axis=0)
        if lims is None:
            lo, hi = pts.min(0), pts.max(0)
            pad = 1e-6 * np.maximum(hi - lo, 1.0)
            lims = np.stack([lo - pad, hi + pad], axis=1)
        self.block = create_3D_block(num_els, p, lims)
        self.ffd = FFDBlock(self.block, pts)
        self.F = jnp.asarray(self.ffd.F)
        self.n_ffd = self.ffd.n_ffd
        self.shape = self.ffd.shape
        self.opt_fields = tuple(opt_fields)
        self.p0 = self.ffd.p0  # (n_ffd, 3) initial block coefficients
        self._cp0_padded = system.cp

    def init_p_ffd(self) -> np.ndarray:
        """Initial design: block coefficients of the optimized fields,
        stacked (n_ffd * n_fields,)."""
        return np.concatenate(
            [self.p0[:, f] for f in self.opt_fields])

    def __call__(self, p_ffd_flat):
        cp = self._cp0_padded
        n = self.n_ffd
        for a, f in enumerate(self.opt_fields):
            vals = self.F @ p_ffd_flat[a * n:(a + 1) * n]
            cp = cp.at[..., f].set(self.layout.to_padded(vals))
        return cp


class _MultiFFDBase:
    """Shared machinery for multi-block FFD: each block controls a
    subset of patches (reference: `set_shopt_multiFFD` /
    `set_thopt_multiFFD`, GOLDFISH/nonmatching_opt_ffd.py:184-428,
    534-685). Design vector = concatenation of all blocks' coefficient
    vectors; each block's evaluation matrix acts on its patches' rows of
    the flat CP vector."""

    def __init__(self, system, groups):
        """groups: list of dicts with keys
        'patches' (indices), 'num_els', 'p', optional 'lims'."""
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp)
        self.blocks = []
        self.Fs = []
        self.rows = []       # flat CP row indices per group
        self.sizes = []
        self.shapes = []
        for g in groups:
            pts = np.concatenate(
                [metas[i].surf.points.reshape(-1, 3)
                 for i in g["patches"]], axis=0)
            rows = np.concatenate(
                [np.arange(self.layout.offsets[i],
                           self.layout.offsets[i + 1])
                 for i in g["patches"]])
            lims = g.get("lims")
            if lims is None:
                lo, hi = pts.min(0), pts.max(0)
                pad = 1e-6 * np.maximum(hi - lo, 1.0)
                lims = np.stack([lo - pad, hi + pad], axis=1)
            block = create_3D_block(g["num_els"], g["p"], lims)
            ffd = FFDBlock(block, pts)
            self.blocks.append(ffd)
            self.Fs.append(jnp.asarray(ffd.F))
            self.rows.append(jnp.asarray(rows, dtype=jnp.int32))
            self.sizes.append(ffd.n_ffd)
            self.shapes.append(ffd.shape)
        self.offsets = np.cumsum([0] + self.sizes)
        self.n_design = int(self.offsets[-1])

    def _flat_field(self, x, per_block_fn):
        """Assemble a flat (n_flat,) field from block coefficients."""
        out = jnp.zeros(self.layout.n_flat, dtype=x.dtype)
        for k, (F, rows) in enumerate(zip(self.Fs, self.rows)):
            xk = per_block_fn(x, k)
            out = out.at[rows].set(F @ xk)
        return out


class MultiThicknessFFD(_MultiFFDBase):
    """Concatenated per-block thickness coefficients -> padded (P, C)."""

    def init_h_ffd(self, h0) -> np.ndarray:
        return np.full(self.n_design, float(h0))

    def __call__(self, x):
        flat = self._flat_field(
            x, lambda xx, k: xx[self.offsets[k]: self.offsets[k + 1]])
        return self.layout.to_padded(flat)


class MultiShapeFFD(_MultiFFDBase):
    """Concatenated per-block, per-field coefficients -> (P, C, 3).

    Design layout: [block0_field_a, block0_field_b, ..., block1_...].
    """

    def __init__(self, system, groups, opt_fields=(0, 1, 2)):
        super().__init__(system, groups)
        self.opt_fields = tuple(opt_fields)
        self._cp0 = system.cp
        self.n_design = self.n_design * len(self.opt_fields)

    def init_p_ffd(self) -> np.ndarray:
        out = []
        for k, ffd in enumerate(self.blocks):
            for f in self.opt_fields:
                out.append(ffd.p0[:, f])
        return np.concatenate(out)

    def __call__(self, x):
        cp = self._cp0
        nf = len(self.opt_fields)
        pos = 0
        for k, (F, rows) in enumerate(zip(self.Fs, self.rows)):
            for a, f in enumerate(self.opt_fields):
                xk = x[pos: pos + self.sizes[k]]
                pos += self.sizes[k]
                flat = jnp.zeros(self.layout.n_flat, dtype=x.dtype)
                flat = flat.at[rows].set(F @ xk)
                upd = self.layout.to_padded(flat)
                mask = jnp.zeros(self.layout.n_flat, dtype=x.dtype)
                mask = mask.at[rows].set(1.0)
                maskp = self.layout.to_padded(mask)
                cp = cp.at[..., f].set(
                    jnp.where(maskp > 0, upd, cp[..., f]))
        return cp
