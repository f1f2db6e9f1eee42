"""Design -> analysis CP pipeline: exactness of the composed
elevation+refinement operator and constraint-row semantics
(reference oracle: bsp_utils.CPSurfDesign2Analysis)."""

import numpy as np

from goldfish_jax.design.cp_design import CPSurfDesign2Analysis
from goldfish_jax.models.tbeam import create_surf


def _surfs():
    pts = [[-1.0, 0, 0], [1.0, 0, 0], [-1.0, 20, 0], [1.0, 20, 0]]
    return [create_surf(pts, 4, 8, 3), create_surf(pts, 4, 8, 3)]


def test_operator_reproduces_geometry():
    surfs = _surfs()
    d2a = CPSurfDesign2Analysis(surfs, design_nel=(2, 2))
    for i in (0, 1):
        for f in range(3):
            x0 = d2a.init_design_cp(i, f)
            cp = d2a.apply(i, x0)
            target = surfs[i].points.reshape(-1, 3)[:, f]
            # bilinear-origin geometry is exactly representable on the
            # coarse design grid
            assert np.abs(cp - target).max() < 1e-9


def test_operator_partition_of_unity():
    surfs = _surfs()
    d2a = CPSurfDesign2Analysis(surfs, design_nel=(2, 2))
    A = d2a.matrix(0)
    assert np.allclose(A.sum(axis=1), 1.0)  # affine invariance
    assert A.shape == (surfs[0].shape[0] * surfs[0].shape[1],
                       d2a.n_design(0))


def test_constraint_rows():
    surfs = _surfs()
    d2a = CPSurfDesign2Analysis(surfs, design_nel=(2, 2))
    nu, nv = d2a.design_shapes[0]
    Aa = d2a.align_rows(0, axis=0)
    assert Aa.shape == ((nu - 1) * nv, nu * nv)
    x = np.tile(np.arange(nv, dtype=float), nu)  # constant along u
    assert np.abs(Aa @ x).max() < 1e-14
    Ar = d2a.regu_rows(0, axis=1)
    xs = np.repeat(np.arange(nu, dtype=float), nv) + np.tile(
        np.linspace(0, 1, nv), nu)
    assert (Ar @ xs > 0).all()  # increasing along v
    Ap = d2a.pin_rows(0, [(0, 0), (nu - 1, nv - 1)])
    assert Ap.shape == (2, nu * nv)
    assert Ap[0, 0] == 1.0 and Ap[1, -1] == 1.0


def test_align_expansion_operator_reproduces_align_null_space():
    """design->full expansion (the reference CPFFDesign2FullComp form,
    tube_shopt_mi_4patch_wffd.py:86-92): columns span exactly the
    align_operator null space — A_align @ (A_exp @ x) == 0 for all x,
    rank(A_exp) = n_design, and the representative dofs reproduce the
    design values (x_full[reps] == x)."""
    import numpy as np

    from goldfish_jax.design.constraints import (
        align_expansion_operator,
        align_operator,
    )

    rng = np.random.default_rng(0)
    for shape, axis in (((3, 4, 5), 2), ((4, 4, 3), 0),
                        ((3, 3, 3), (1, 2))):
        A_exp, reps = align_expansion_operator(shape, axis)
        n_full = int(np.prod(shape))
        ax = (axis,) if np.ndim(axis) == 0 else tuple(axis)
        n_design = int(np.prod([s for a, s in enumerate(shape)
                                if a not in ax]))
        assert A_exp.shape == (n_full, n_design)
        assert reps.shape == (n_design,)
        A_al = align_operator(shape, axis)
        x = rng.normal(size=n_design)
        full = A_exp @ x
        np.testing.assert_allclose(A_al @ full, 0.0, atol=1e-14)
        np.testing.assert_allclose(full[reps], x)
        # every full dof is driven by exactly one design dof
        np.testing.assert_allclose(A_exp.sum(axis=1), 1.0)


def test_xi_interior_dofs_excludes_pinned_coordinates():
    """geometry/cpiga2xi.xi_interior_dofs: the returned dofs are
    disjoint from the edge-pinned columns, initial values sit strictly
    inside (0, 1), and every EXCLUDED real dof is at a pinned/boundary
    coordinate — the support of the reference XiConsComp bound
    (tube_shopt_mi_4patch_wffd.py:233-234)."""
    import numpy as np

    from demos.draft_tube_shopt_mi_wffd import build_mi_tube
    from goldfish_jax.geometry.cpiga2xi import (
        xi_edge_constraints,
        xi_interior_dofs,
    )

    sys_ = build_mi_tube(num_el=2, p=2)
    mi = sys_.mi
    free = xi_interior_dofs(mi)
    assert free.size > 0
    edge_dofs, _ = xi_edge_constraints(mi)
    assert not set(free.tolist()) & set(edge_dofs.tolist())
    xi0 = np.asarray(mi.xi0).ravel()
    # free dofs may START at 0/1 only if not structurally forced there
    # (advisor r4: a coincidental boundary start must stay constrained)
    assert xi0[free].min() >= 0.0 and xi0[free].max() <= 1.0
    # excluded REAL dofs (not padding) are STRUCTURALLY pinned: an edge
    # column, an end-pinned coordinate, or a mating-side endpoint
    # coordinate forced to 0/1 by a boundary-terminating seam end
    # (side-A end_val itself at 0/1)
    n_pts = np.asarray(mi.n_pts)
    N = np.asarray(mi.xi0).shape[1]
    end_dir = np.asarray(mi.end_dir)
    end_val = np.asarray(mi.end_val)
    freeset = set(free.tolist())
    edgeset = set(edge_dofs.tolist())
    for i in range(np.asarray(mi.xi0).shape[0]):
        for k in range(int(n_pts[i])):
            for side in (0, 1):
                for c in (0, 1):
                    dof = ((i * N + k) * 2 + side) * 2 + c
                    if dof in freeset:
                        continue
                    pinned = dof in edgeset
                    pinned |= side == 0 and (
                        (k == 0 and c == int(end_dir[i, 0]))
                        or (k == int(n_pts[i]) - 1
                            and c == int(end_dir[i, 1])))
                    end = (0 if k == 0
                           else (1 if k == int(n_pts[i]) - 1 else None))
                    if end is not None and side == 1:
                        ev = float(end_val[i, end])
                        pinned |= (min(abs(ev), abs(ev - 1.0)) < 1e-9
                                   and (abs(xi0[dof]) < 1e-9
                                        or abs(xi0[dof] - 1.0) < 1e-9))
                    assert pinned, (i, k, side, c, xi0[dof])


def test_xi_interior_dofs_keeps_unforced_boundary_starts():
    """Exclusion (d) must NOT drop an endpoint coordinate that merely
    starts at 0/1 without the structural force: a side-B boundary
    start at an end whose side-A pin is INTERIOR (end_val strictly
    inside (0,1)) stays in the KS aggregate (advisor finding, r4)."""
    import numpy as np

    from demos.draft_tube_shopt_mi_wffd import build_mi_tube
    from goldfish_jax.geometry.cpiga2xi import (
        xi_edge_constraints,
        xi_interior_dofs,
    )

    sys_ = build_mi_tube(num_el=2, p=2)
    mi = sys_.mi
    # side-B endpoint dofs at 0/1 under a boundary end pin (and not
    # edge-pinned columns, which stay excluded regardless): excluded
    free0 = set(xi_interior_dofs(mi).tolist())
    edgeset = set(xi_edge_constraints(mi)[0].tolist())
    xi0 = np.asarray(mi.xi0)
    N = xi0.shape[1]
    forced = []
    for i in range(mi.n_int):
        n = int(np.asarray(mi.n_pts)[i])
        for k, end in ((0, 0), (n - 1, 1)):
            ev = float(np.asarray(mi.end_val)[i, end])
            if min(abs(ev), abs(ev - 1.0)) > 1e-9:
                continue
            for c in (0, 1):
                dof = ((i * N + k) * 2 + 1) * 2 + c
                v = float(xi0[i, k, 1, c])
                if dof not in edgeset \
                        and min(abs(v), abs(v - 1.0)) < 1e-9:
                    forced.append(dof)
    assert forced and not (set(forced) & free0)
    # now re-pin the same ends to an INTERIOR isoline: the same
    # boundary-valued side-B coordinates must become FREE
    mi2 = mi._replace(end_val=np.full_like(np.asarray(mi.end_val), 0.3))
    free2 = set(xi_interior_dofs(mi2).tolist())
    assert set(forced) <= free2
