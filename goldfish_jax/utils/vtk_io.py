"""VTK output for shells: sampled surfaces + control nets.

Replaces the reference's ParaView pipeline (FEniCS `File(...pvd)` written
from `create_files`/`save_files`, reference: GOLDFISH/nonmatching_opt.py
:1448-1576, plus `VTKWriter` in utils/ffd_utils.py:164-346): legacy-VTK
structured grids written directly from NURBS evaluations, one file per
patch per snapshot, with displacement / thickness / von Mises point
data. No FEniCS, no ParaView-python dependency for writing.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_structured_vtk", "write_cp_vtk", "write_vtu",
           "PVDSeries", "SurfaceWriter"]


def write_structured_vtk(path, points, point_data=None):
    """Legacy-ASCII VTK structured grid.

    points: (n_u, n_v, 3) (surfaces) or (n_u, n_v, n_w, 3) (FFD blocks);
    point_data: dict name -> (n_u, n_v[, n_w]) scalars or (..., 3)
    vectors.
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 3:
        pts = pts[:, :, None, :]
    nu, nv, nw, _ = pts.shape
    n = nu * nv * nw
    # VTK structured grids index x fastest
    order = pts.transpose(2, 1, 0, 3).reshape(-1, 3)
    lines = [
        "# vtk DataFile Version 3.0",
        "goldfish_jax surface",
        "ASCII",
        "DATASET STRUCTURED_GRID",
        f"DIMENSIONS {nu} {nv} {nw}",
        f"POINTS {n} double",
    ]
    lines += [" ".join(f"{x:.16g}" for x in row) for row in order]
    if point_data:
        lines.append(f"POINT_DATA {n}")
        for name, arr in point_data.items():
            a = np.asarray(arr, dtype=np.float64)
            is_vector = a.shape[-1] == 3 and a.ndim >= 3
            if is_vector:
                if a.ndim == 3:  # (nu, nv, 3) -> (nu, nv, 1, 3)
                    a = a[:, :, None, :]
                flat = a.transpose(2, 1, 0, 3).reshape(-1, 3)
                lines.append(f"VECTORS {name} double")
                lines += [" ".join(f"{x:.16g}" for x in r) for r in flat]
            else:
                if a.ndim == 2:  # (nu, nv) -> (nu, nv, 1)
                    a = a[:, :, None]
                flat = a.transpose(2, 1, 0).reshape(-1)
                lines += [f"SCALARS {name} double 1",
                          "LOOKUP_TABLE default"]
                lines += [f"{x:.16g}" for x in flat]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _xml_array(name, a, ncomp, dtype="Float64"):
    flat = np.asarray(a).reshape(-1)
    body = " ".join(f"{x:.16g}" if dtype == "Float64" else str(int(x))
                    for x in flat)
    nm = f' Name="{name}"' if name else ""
    return (f'<DataArray type="{dtype}"{nm} '
            f'NumberOfComponents="{ncomp}" format="ascii">\n'
            f"{body}\n</DataArray>")


def write_vtu(path, points, point_data=None):
    """ParaView-pipeline-compatible XML UnstructuredGrid (`.vtu`).

    The reference's output files are `.pvd`/`.vtu` series written by
    FEniCS `File` objects (reference: GOLDFISH/nonmatching_opt.py
    :1448-1576) and consumed by its ParaView CLI
    (visualization/view_results.py:1-40); a user's existing ParaView
    workflow expects that format. This writer emits the same file
    family from a structured (n_u, n_v, 3) NURBS sample: points in
    v-major order and one VTK_QUAD (type 9) cell per sample-grid cell.

    point_data: dict name -> (n_u, n_v) scalars or (n_u, n_v, 3)
    vectors (same convention as `write_structured_vtk`).
    """
    pts = np.asarray(points, dtype=np.float64)
    assert pts.ndim == 3 and pts.shape[-1] == 3, pts.shape
    nu, nv, _ = pts.shape
    n = nu * nv
    # match the legacy writer's file order (x fastest <=> u fastest)
    order = pts.transpose(1, 0, 2).reshape(-1, 3)

    def pid(iu, iv):
        return iv * nu + iu

    conn = []
    for iv in range(nv - 1):
        for iu in range(nu - 1):
            conn.append([pid(iu, iv), pid(iu + 1, iv),
                         pid(iu + 1, iv + 1), pid(iu, iv + 1)])
    conn = np.asarray(conn, dtype=np.int64)
    ncell = conn.shape[0]

    pdata = []
    for name, arr in (point_data or {}).items():
        a = np.asarray(arr, dtype=np.float64)
        if a.ndim == 3 and a.shape[-1] == 3:
            flat = a.transpose(1, 0, 2).reshape(-1, 3)
            pdata.append(_xml_array(name, flat, 3))
        else:
            assert a.shape == (nu, nv), (name, a.shape)
            pdata.append(_xml_array(name, a.transpose(1, 0), 1))

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{n}" NumberOfCells="{ncell}">
<Points>
{_xml_array(None, order, 3)}
</Points>
<Cells>
{_xml_array("connectivity", conn, 1, "Int32")}
{_xml_array("offsets", 4 * np.arange(1, ncell + 1), 1, "Int32")}
{_xml_array("types", np.full(ncell, 9), 1, "UInt8")}
</Cells>
<PointData>
{chr(10).join(pdata)}
</PointData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(xml)


class PVDSeries:
    """ParaView collection (`.pvd`) time-series writer — the role of
    one FEniCS `File("....pvd")` in the reference (nonmatching_opt.py
    :1448-1576: one pvd per field per patch, re-written every
    `save_files` call so the series is openable mid-run)."""

    def __init__(self, path):
        self.path = path
        self.entries = []  # (timestep, part, relative file)

    def add(self, file, timestep, part=0):
        rel = os.path.relpath(file, os.path.dirname(self.path) or ".")
        self.entries.append((float(timestep), int(part), rel))
        self.write()

    def write(self):
        rows = "\n".join(
            f'<DataSet timestep="{t:g}" part="{p}" file="{f}"/>'
            for t, p, f in sorted(self.entries))
        xml = ('<?xml version="1.0"?>\n'
               '<VTKFile type="Collection" version="0.1" '
               'byte_order="LittleEndian">\n<Collection>\n'
               f"{rows}\n</Collection>\n</VTKFile>\n")
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            f.write(xml)


def write_cp_vtk(path, control_points):
    """Control-net output (reference VTKWriter.write_cp)."""
    cp = np.asarray(control_points, dtype=np.float64)
    if cp.shape[-1] == 4:
        cp = cp[..., :3] / cp[..., 3:4]
    write_structured_vtk(path, cp)


class SurfaceWriter:
    """Per-major-iteration snapshot writer (the role of the reference's
    create_files/save_files called from DispStatesComp.linearize,
    reference: om_comps/disp_states_comp.py:100-105)."""

    def __init__(self, system, save_path="./results", n_eval=33,
                 fmt="vtk"):
        """fmt: 'vtk' (legacy ASCII, the matplotlib viewer's native
        input) or 'vtu' (XML + a per-patch `.pvd` time series, the
        reference's ParaView pipeline format — an existing ParaView
        workflow opens `surf{ip}.pvd` and scrubs iterations)."""
        assert fmt in ("vtk", "vtu"), fmt
        self.system = system
        self.save_path = save_path
        self.n_eval = n_eval
        self.fmt = fmt
        self.counter = 0
        self._pvd = {}

    def save(self, d=None, h=None, tag=None):

        from goldfish_jax.ops.bspline import rational_basis_2d

        tag = self.counter if tag is None else tag
        u = np.linspace(0, 1, self.n_eval)
        for ip, meta in enumerate(self.system.metas):
            s = meta.surf
            X = s.evaluate(u, u)
            data = {}
            grid = np.stack(np.meshgrid(u, u, indexing="ij"), -1).reshape(-1, 2)
            conn, tab = rational_basis_2d(
                s.knots[0], s.knots[1], *s.degree, s.weights, grid, nd=0)
            if d is not None:
                dloc = np.asarray(d[ip])[conn]
                disp = np.einsum("nl,nlk->nk", tab[(0, 0)], dloc)
                data["displacement"] = disp.reshape(self.n_eval,
                                                    self.n_eval, 3)
            if h is not None:
                hloc = np.asarray(h[ip])[conn]
                th = np.einsum("nl,nl->n", tab[(0, 0)], hloc)
                data["thickness"] = th.reshape(self.n_eval, self.n_eval)
            if self.fmt == "vtu":
                path = os.path.join(self.save_path,
                                    f"surf{ip}_iter{tag}.vtu")
                write_vtu(path, X, data)
                if ip not in self._pvd:
                    self._pvd[ip] = PVDSeries(os.path.join(
                        self.save_path, f"surf{ip}.pvd"))
                self._pvd[ip].add(path, timestep=self.counter)
            else:
                write_structured_vtk(
                    os.path.join(self.save_path,
                                 f"surf{ip}_iter{tag}.vtk"), X, data)
        self.counter += 1
