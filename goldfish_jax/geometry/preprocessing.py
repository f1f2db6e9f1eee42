"""Surface-surface intersection preprocessing (OCCPreprocessing
replacement).

The reference delegates to pythonOCC/OpenCASCADE via PENGoLINS'
`OCCPreprocessing` (reference: plate demo usage at
demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:239-255:
`compute_intersections(rtol, mortar_refine)`, `mortar_nels`,
`mapping_list`, `intersections_para_coords`, save/load npz caches).
This implementation is OCC-free:

  1. bounding-box pair culling;
  2. dense parametric sampling of side A + batched Newton closest-point
     projection onto side B (host numpy, vectorized over all samples);
  3. PCA line fit of the hit set in A's parameter space, bisection
     extension of the parametric segment to the true curve extent;
  4. exact placement of n equally-spaced points via the CPIGA2Xi
     residual solve (geometry/cpiga2xi.py) — the same machinery the
     moving-intersection optimization uses.

The npz cache format mirrors the reference's field layout
(name1..name6) so caches interchange with reference workflows.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.ops.bspline import rational_basis_2d

__all__ = ["closest_point_projection", "Preprocessor"]


def _eval_many(surf: NURBS, uv, nd=1):
    p, q = surf.degree
    conn, tab = rational_basis_2d(
        surf.knots[0], surf.knots[1], p, q, surf.weights, uv, nd=nd)
    flat = surf.points.reshape(-1, 3)
    loc = flat[conn]
    out = {k: np.einsum("ml,mlk->mk", tab[k], loc) for k in tab}
    return out


def closest_point_projection(surf: NURBS, X, uv0=None, max_it=30,
                             tol=1e-12):
    """Batched projected-Newton closest point: min_uv |S(uv) - X|^2,
    clamped to the unit parameter box. X: (m, 3). Returns (uv, dist)."""
    X = np.asarray(X, dtype=np.float64).reshape(-1, 3)
    m = X.shape[0]
    if uv0 is None:
        # coarse seeding on a grid
        g = np.linspace(0, 1, 9)
        gg = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
        S = _eval_many(surf, gg, nd=0)[(0, 0)]
        d2 = ((X[:, None, :] - S[None, :, :]) ** 2).sum(-1)
        uv = gg[np.argmin(d2, axis=1)].copy()
    else:
        uv = np.asarray(uv0, dtype=np.float64).reshape(-1, 2).copy()

    for _ in range(max_it):
        E = _eval_many(surf, uv, nd=2)
        r = E[(0, 0)] - X                      # (m, 3)
        Su, Sv = E[(1, 0)], E[(0, 1)]
        g1 = (r * Su).sum(-1)
        g2 = (r * Sv).sum(-1)
        h11 = (Su * Su).sum(-1) + (r * E[(2, 0)]).sum(-1)
        h12 = (Su * Sv).sum(-1) + (r * E[(1, 1)]).sum(-1)
        h22 = (Sv * Sv).sum(-1) + (r * E[(0, 2)]).sum(-1)
        det = h11 * h22 - h12 * h12
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        du = -(h22 * g1 - h12 * g2) / det
        dv = -(-h12 * g1 + h11 * g2) / det
        step = np.stack([du, dv], -1)
        ns = np.linalg.norm(step, axis=-1, keepdims=True)
        step = np.where(ns > 0.25,
                        step * 0.25 / np.maximum(ns, 1e-30),
                        step)  # trust region
        uv = np.clip(uv + step, 0.0, 1.0)
        if np.max(np.abs(step)) < tol:
            break
    E = _eval_many(surf, uv, nd=0)
    dist = np.linalg.norm(E[(0, 0)] - X, axis=-1)
    return uv, dist


class Preprocessor:
    """Compute / cache patch-patch intersection data."""

    def __init__(self, surfs: list[NURBS]):
        self.surfs = surfs
        self.num_intersections = 0
        self.mapping_list: list[list[int]] = []
        self.intersections_para_coords: list[list[np.ndarray]] = []
        self.intersections_phy_coords: list[np.ndarray] = []
        self.intersections_length: list[float] = []
        self.mortar_nels: list[int] = []
        self.intersections_type: list[str] = []

    # ------------------------------------------------------ computation
    def compute_intersections(self, rtol=1e-4, mortar_refine=2,
                              n_sample=25):
        from goldfish_jax.geometry.cpiga2xi import CPIGA2Xi
        from goldfish_jax.physics.coupling import InterfaceSpec

        surfs = self.surfs
        diag = np.linalg.norm(
            np.max([s.bounds()[1] for s in surfs], axis=0)
            - np.min([s.bounds()[0] for s in surfs], axis=0))
        tol = rtol * diag

        g = np.linspace(0, 1, n_sample)
        grid = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)

        found = []
        for ia in range(len(surfs)):
            A = surfs[ia]
            SA = _eval_many(A, grid, nd=0)[(0, 0)]
            loA, hiA = A.bounds()
            # DETECTION tolerance: half the physical sample spacing —
            # a curve can pass up to that far from every grid sample
            # (tight `tol` is for VERIFICATION of traced curves only;
            # without this split, curved curves between grid lines are
            # silently missed)
            SAg = SA.reshape(n_sample, n_sample, 3)
            sp_u = np.linalg.norm(np.diff(SAg, axis=0), axis=-1).max()
            sp_v = np.linalg.norm(np.diff(SAg, axis=1), axis=-1).max()
            det_tol = max(tol, 0.75 * max(sp_u, sp_v))
            for ib in range(ia + 1, len(surfs)):
                B = surfs[ib]
                loB, hiB = B.bounds()
                if np.any(loA > hiB + tol) or np.any(loB > hiA + tol):
                    continue
                uvB, dist = closest_point_projection(B, SA)
                # prefer TIGHT hits (grid samples essentially ON the
                # curve — always the case for edge-touching patches);
                # fall back to the loose detection band, whose PCA
                # line must then be SNAPPED onto the curve
                hits_tight = dist < tol
                loose = hits_tight.sum() < 3
                hits = (dist < det_tol) if loose else hits_tight
                if hits.sum() < 3:
                    continue
                seg = self._fit_segment(A, B, grid[hits], tol,
                                        snap=loose)
                if seg is None:
                    continue
                endsA, endsB, length = seg
                nelA = max(len(np.unique(A.knots[0])),
                           len(np.unique(A.knots[1]))) - 1
                nelB = max(len(np.unique(B.knots[0])),
                           len(np.unique(B.knots[1]))) - 1
                nel = mortar_refine * max(nelA, nelB)
                found.append((ia, ib, endsA, endsB, length, nel))

        # refine every curve: edge-type directly (the coplanar-safe
        # path: arc-length placement + projection), transversal curves
        # with the implicit CPIGA2Xi solve
        for (ia, ib, endsA, endsB, length, nel) in found:
            n = max(nel + 1, 3)
            if self._is_edge_segment(endsA, tol=1e-9) or \
                    self._is_edge_segment(endsB, tol=1e-9):
                xiA, xiB = self._refine_edge_curve(
                    self.surfs[ia], self.surfs[ib], endsA, n)
                if xiA is None:
                    continue
            else:
                # transversal curve: MARCH along it (handles curved
                # parametric curves, not just straight segments), then
                # equal-arc-length polish via the CPIGA2Xi solve seeded
                # with the traced polyline
                xiA, xiB = self._trace_curve(
                    self.surfs[ia], self.surfs[ib], endsA, n, tol)
                if xiA is None:
                    continue
                import jax.numpy as jnp

                spec = InterfaceSpec(pair=(0, 1), xi_ends_A=endsA,
                                     xi_ends_B=np.stack(
                                         [xiB[0], xiB[-1]]),
                                     n_mortar_el=nel,
                                     xi_pts_A=xiA, xi_pts_B=xiB)
                c2x = CPIGA2Xi([self.surfs[ia], self.surfs[ib]], [spec],
                               n_pts_list=[n])
                max_cp = c2x.ss.w.shape[1]
                cp = np.zeros((2, max_cp, 3))
                for k, s in ((0, self.surfs[ia]), (1, self.surfs[ib])):
                    flat = s.points.reshape(-1, 3)
                    cp[k, : flat.shape[0]] = flat
                x = c2x.solve(jnp.asarray(cp))
                res = c2x.residual_norm(jnp.asarray(cp), x)
                if np.isfinite(res) and res <= 1e-6 * max(diag, 1.0):
                    xi = np.asarray(x).reshape(-1, 2, 2)[:n]
                    xiA, xiB = xi[:, 0, :], xi[:, 1, :]
                # else keep the traced polyline (graph-over-chord)
            phys = _eval_many(self.surfs[ia], xiA, nd=0)[(0, 0)]

            self.mapping_list.append([ia, ib])
            self.intersections_para_coords.append(
                [np.asarray(xiA), np.asarray(xiB)])
            self.intersections_phy_coords.append(phys)
            self.intersections_length.append(float(np.sum(
                np.linalg.norm(np.diff(phys, axis=0), axis=-1))))
            self.mortar_nels.append(int(nel))
            self.intersections_type.append(self._classify(xiA, xiB))
        self.num_intersections = len(self.mapping_list)
        return self

    def _snap_to_curve(self, A, B, uv, e_perp, tol, span):
        """Slide uv along e_perp to the closest-to-B point (two grid
        refinements); returns (uv_snapped, distance)."""
        best = (np.asarray(uv, dtype=float), np.inf)
        lo, hi = -span, span
        for _ in range(3):
            s = np.linspace(lo, hi, 33)
            uvs = np.clip(uv[None] + s[:, None] * e_perp[None], 0.0, 1.0)
            X = _eval_many(A, uvs, nd=0)[(0, 0)]
            _, dd = closest_point_projection(B, X)
            k = int(np.argmin(dd))
            best = (uvs[k], float(dd[k]))
            step = s[1] - s[0]
            lo, hi = s[k] - step, s[k] + step
        return best

    def _fit_segment(self, A, B, uv_hits, tol, snap=False):
        """PCA line through the hit set in A's parameter space, extended
        by bisection to the curve's true extent; endpoints projected to
        B. With `snap` (loose detection band), every probed point is
        first slid TRANSVERSE to the line onto the actual curve — the
        band's PCA line can sit well off it, and CURVED curves leave
        any straight line."""
        c = uv_hits.mean(axis=0)
        U, S, Vt = np.linalg.svd(uv_hits - c, full_matrices=False)
        if S[0] < 1e-10:
            return None
        e1 = Vt[0]
        e_perp = np.array([-e1[1], e1[0]])
        span = float((np.abs((uv_hits - c) @ e_perp)).max() + 0.05) \
            if snap else 0.0
        if snap:
            c, dc = self._snap_to_curve(A, B, c, e_perp, tol, span)
            if dc > tol:
                return None
        t = (uv_hits - c) @ e1
        tmin, tmax = t.min(), t.max()

        def probe(tv):
            uv = np.clip(c + tv * e1, 0.0, 1.0)
            if snap:
                uv, d = self._snap_to_curve(A, B, uv, e_perp, tol, span)
                return uv, d
            X = _eval_many(A, uv[None, :], nd=0)[(0, 0)]
            _, d = closest_point_projection(B, X)
            return uv, float(d[0])

        def on_curve(tv):
            uv, d = probe(tv)
            inside = np.all(uv >= -1e-12) and np.all(uv <= 1 + 1e-12)
            return inside and d < tol

        def extend(t0, direction):
            # largest step in `direction` still on the curve & in box
            lo, hi = 0.0, 2.0
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if on_curve(t0 + direction * mid):
                    lo = mid
                else:
                    hi = mid
            return t0 + direction * lo

        tmin = extend(tmin, -1.0)
        tmax = extend(tmax, +1.0)
        endA0 = np.clip(probe(tmin)[0], 0.0, 1.0)
        endA1 = np.clip(probe(tmax)[0], 0.0, 1.0)
        X = _eval_many(A, np.stack([endA0, endA1]), nd=0)[(0, 0)]
        uvB, dB = closest_point_projection(B, X)
        if np.any(dB > 10 * tol):
            return None
        phys_len = np.linalg.norm(X[1] - X[0])
        if phys_len < 10 * tol:
            return None
        return (np.stack([endA0, endA1]), uvB, phys_len)

    def _trace_curve(self, A, B, endsA, n, tol):
        """March along a (possibly CURVED) transversal intersection:
        n points seeded on the A-side chord, each Newton-corrected onto
        the true curve. Unknowns per point: (uvA, uvB); equations:
        F_A(uvA) - F_B(uvB) = 0 (3) + chord-coordinate constraint
        (uvA - chord(t)) . e1 = 0 (1) — the correction moves uvA only
        TRANSVERSE to the chord, so curved curves that are graphs over
        their chord are captured exactly (the reference gets these
        polylines from OCC; reference usage
        demos_om/shape_opt_mint/T-beam/T_beam_2patch_shopt_mi_curved.py).
        Returns (xiA, xiB) polylines or (None, None)."""
        e1 = endsA[1] - endsA[0]
        ln = np.linalg.norm(e1)
        if ln < 1e-14:
            return None, None
        e1 = e1 / ln
        t = np.linspace(0.0, 1.0, n)
        chord = (1 - t)[:, None] * endsA[0] + t[:, None] * endsA[1]
        X0 = _eval_many(A, chord, nd=0)[(0, 0)]
        uvB, _ = closest_point_projection(B, X0)
        uvA = chord.copy()

        for _ in range(30):
            FA = _eval_many(A, uvA, nd=1)
            FB = _eval_many(B, uvB, nd=1)
            r3 = FA[(0, 0)] - FB[(0, 0)]                 # (n, 3)
            r1 = np.einsum("nk,k->n", uvA - chord, e1)   # (n,)
            rn = np.sqrt(np.sum(r3**2, -1) + r1**2)
            if np.max(rn) < 1e-12 * max(1.0, np.max(np.abs(X0))):
                break
            # batched 4x4 Newton
            J = np.zeros((n, 4, 4))
            J[:, :3, 0] = FA[(1, 0)]
            J[:, :3, 1] = FA[(0, 1)]
            J[:, :3, 2] = -FB[(1, 0)]
            J[:, :3, 3] = -FB[(0, 1)]
            J[:, 3, 0] = e1[0]
            J[:, 3, 1] = e1[1]
            rhs = np.concatenate([r3, r1[:, None]], axis=1)
            try:
                dx = np.linalg.solve(J, rhs[..., None])[..., 0]
            except np.linalg.LinAlgError:
                return None, None
            uvA = np.clip(uvA - dx[:, :2], 0.0, 1.0)
            uvB = np.clip(uvB - dx[:, 2:], 0.0, 1.0)
        else:
            return None, None
        # verify physical coincidence
        XA = _eval_many(A, uvA, nd=0)[(0, 0)]
        XB = _eval_many(B, uvB, nd=0)[(0, 0)]
        if np.max(np.linalg.norm(XA - XB, axis=-1)) > tol:
            return None, None
        return uvA, uvB

    @staticmethod
    def _is_edge_segment(ends, tol=1e-9):
        """True if the parametric segment runs along a boundary edge."""
        for c in range(2):
            v = ends[:, c]
            if (np.all(np.abs(v) < tol) or np.all(np.abs(v - 1) < tol)) \
                    and abs(ends[1][1 - c] - ends[0][1 - c]) > tol:
                return True
        return False

    def _refine_edge_curve(self, A, B, endsA, n):
        """Edge-type intersection: equal-arc-length points along A's
        parametric segment, each projected onto B (well-posed even for
        coplanar/tangential junctions where the 3D coincidence Jacobian
        is singular)."""
        # dense sampling of the segment on A
        m = max(8 * n, 64)
        t = np.linspace(0.0, 1.0, m)
        uv = (1 - t)[:, None] * endsA[0] + t[:, None] * endsA[1]
        X = _eval_many(A, uv, nd=0)[(0, 0)]
        seg = np.linalg.norm(np.diff(X, axis=0), axis=-1)
        s = np.concatenate([[0.0], np.cumsum(seg)])
        if s[-1] < 1e-14:
            return None, None
        s_target = np.linspace(0.0, s[-1], n)
        t_n = np.interp(s_target, s, t)
        xiA = (1 - t_n)[:, None] * endsA[0] + t_n[:, None] * endsA[1]
        Xn = _eval_many(A, xiA, nd=0)[(0, 0)]
        xiB, dist = closest_point_projection(B, Xn)
        if not np.all(np.isfinite(xiB)):
            return None, None
        return xiA, xiB

    @staticmethod
    def _classify(xiA, xiB, tol=1e-6):
        """'edge' if either side's curve runs along a parametric
        boundary edge (reference check_intersections_type /
        intersections_type), else 'surf'."""
        for xi in (xiA, xiB):
            for c in range(2):
                if np.all(np.abs(xi[:, c]) < tol) or \
                        np.all(np.abs(xi[:, c] - 1) < tol):
                    return "edge"
        return "surf"

    # ------------------------------------------------------------ cache
    def save_intersections_data(self, path):
        """Reference-compatible npz layout (name1..name6; cf. the
        shipped plate_int_data.npz)."""
        np.savez(
            path,
            name1=np.int64(self.num_intersections),
            name2=np.asarray(self.mapping_list, dtype=np.int64),
            name3=np.asarray(self.intersections_phy_coords, dtype=object),
            name4=np.asarray(
                [[p[0], p[1]] for p in self.intersections_para_coords],
                dtype=object),
            name5=np.asarray(self.intersections_length),
            name6=np.asarray(self.mortar_nels, dtype=np.int64),
            allow_pickle=True)

    def load_intersections_data(self, path):
        z = np.load(path, allow_pickle=True)
        self.num_intersections = int(z["name1"])
        self.mapping_list = [list(map(int, r)) for r in z["name2"]]
        self.intersections_phy_coords = list(z["name3"])
        self.intersections_para_coords = [
            [np.asarray(r[0]), np.asarray(r[1])] for r in z["name4"]]
        self.intersections_length = list(np.atleast_1d(z["name5"]))
        self.mortar_nels = list(map(int, z["name6"]))
        self.intersections_type = [
            self._classify(p[0], p[1])
            for p in self.intersections_para_coords]
        return self

    # --------------------------------------------------------- adapters
    def interface_specs(self):
        """InterfaceSpecs carrying the FULL refined parametric
        polylines (curved curves included; the reference feeds
        intersections_para_coords the same way,
        GOLDFISH/cpiga2xi.py:43-57)."""
        from goldfish_jax.physics.coupling import InterfaceSpec

        specs = []
        for (pair, (xiA, xiB), nel) in zip(
                self.mapping_list, self.intersections_para_coords,
                self.mortar_nels):
            specs.append(InterfaceSpec(
                pair=tuple(pair),
                xi_ends_A=np.stack([xiA[0], xiA[-1]]),
                xi_ends_B=np.stack([xiB[0], xiB[-1]]),
                n_mortar_el=int(nel),
                xi_pts_A=np.asarray(xiA), xi_pts_B=np.asarray(xiB)))
        return specs
