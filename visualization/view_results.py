#!/usr/bin/env python
"""Post-processing CLI over saved optimization results.

The reference ships a ParaView-python script
(reference: visualization/view_results.py) that renders saved pvd/vtu
files. This equivalent works on the rebuild's outputs without ParaView:

  - reads the legacy-VTK surface snapshots written by
    goldfish_jax.utils.vtk_io.SurfaceWriter and/or the optimization
    checkpoints written by goldfish_jax.utils.checkpoint.Checkpointer;
  - prints summary statistics (displacement extrema, thickness range,
    objective history);
  - optionally renders matplotlib PNGs (deformed surface scatter,
    thickness maps, convergence history).

Usage:
  python visualization/view_results.py RESULTS_DIR [--png OUT_PREFIX]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np


def read_structured_vtk(path):
    """Minimal reader for the legacy-ASCII files vtk_io writes."""
    with open(path) as f:
        lines = f.read().splitlines()
    it = iter(lines)
    dims = None
    pts = None
    data = {}
    n = 0
    while True:
        try:
            line = next(it)
        except StopIteration:
            break
        if line.startswith("DIMENSIONS"):
            dims = tuple(int(x) for x in line.split()[1:4])
        elif line.startswith("POINTS"):
            n = int(line.split()[1])
            vals = []
            while len(vals) < 3 * n:
                vals.extend(float(x) for x in next(it).split())
            pts = np.asarray(vals).reshape(n, 3)
        elif line.startswith("VECTORS"):
            name = line.split()[1]
            vals = []
            while len(vals) < 3 * n:
                vals.extend(float(x) for x in next(it).split())
            data[name] = np.asarray(vals).reshape(n, 3)
        elif line.startswith("SCALARS"):
            name = line.split()[1]
            next(it)  # LOOKUP_TABLE
            vals = []
            while len(vals) < n:
                vals.extend(float(x) for x in next(it).split())
            data[name] = np.asarray(vals)
    return dims, pts, data


def read_vtu(path):
    """Reader for the XML UnstructuredGrid files vtk_io.write_vtu
    emits (ParaView-pipeline format). Returns (None, points, data) —
    same tuple shape as read_structured_vtk (vtu has no dims)."""
    import xml.etree.ElementTree as ET

    piece = ET.parse(path).getroot().find(".//Piece")
    data = {}
    pts = None
    for da in piece.iter("DataArray"):
        vals = np.asarray(da.text.split(), dtype=np.float64)
        ncomp = int(da.get("NumberOfComponents", "1"))
        arr = vals.reshape(-1, ncomp) if ncomp > 1 else vals
        name = da.get("Name")
        if name is None:  # the Points array
            pts = arr
        elif name not in ("connectivity", "offsets", "types"):
            data[name] = arr
    return None, pts, data


def read_pvd(path):
    """ParaView collection: [(timestep, absolute vtu path), ...]."""
    import xml.etree.ElementTree as ET

    base = os.path.dirname(os.path.abspath(path))
    return [(float(ds.get("timestep")), os.path.join(base, ds.get("file")))
            for ds in ET.parse(path).getroot().iter("DataSet")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dir")
    ap.add_argument("--png", default=None,
                    help="prefix for matplotlib PNG output")
    args = ap.parse_args()

    vtks = sorted(glob.glob(os.path.join(args.results_dir, "surf*.vtk"))
                  + glob.glob(os.path.join(args.results_dir, "surf*.vtu")))
    ckpt = os.path.join(args.results_dir, "opt_state.npz")

    if os.path.exists(ckpt):
        z = np.load(ckpt, allow_pickle=False)
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files \
            else {}
        print(f"checkpoint: iter={meta.get('iter')} J={meta.get('J')}")
        for k in z.files:
            if k.startswith("design__"):
                v = z[k]
                print(f"  design {k[8:]}: shape {v.shape} "
                      f"range [{v.min():.4e}, {v.max():.4e}]")

    groups = {}
    for p in vtks:
        m = re.match(r".*surf(\d+)_iter(\w+)\.(vtk|vtu)", p)
        if m:
            groups.setdefault(m.group(2), []).append((int(m.group(1)), p))

    def read_any(p):
        return read_vtu(p) if p.endswith(".vtu") \
            else read_structured_vtk(p)
    for tag, items in sorted(groups.items()):
        print(f"snapshot '{tag}': {len(items)} patches")
        umax, hmin, hmax = 0.0, np.inf, -np.inf
        for (_, p) in items:
            _, pts, data = read_any(p)
            if "displacement" in data:
                umax = max(umax,
                           np.linalg.norm(data["displacement"], axis=1).max())
            if "thickness" in data:
                hmin = min(hmin, data["thickness"].min())
                hmax = max(hmax, data["thickness"].max())
        print(f"  max |u| = {umax:.5e}"
              + (f", h in [{hmin:.4e}, {hmax:.4e}]"
                 if np.isfinite(hmin) else ""))

        if args.png:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig = plt.figure(figsize=(9, 4))
            ax = fig.add_subplot(121, projection="3d")
            ax2 = fig.add_subplot(122)
            for (ip, p) in items:
                _, pts, data = read_any(p)
                u = data.get("displacement", np.zeros_like(pts))
                x = pts + u
                c = np.linalg.norm(u, axis=1)
                ax.scatter(x[:, 0], x[:, 1], x[:, 2], c=c, s=2)
                if "thickness" in data:
                    ax2.scatter(pts[:, 0], pts[:, 1],
                                c=data["thickness"], s=4)
            ax.set_title(f"deformed (|u|), iter {tag}")
            ax2.set_title("thickness")
            out = f"{args.png}_iter{tag}.png"
            fig.savefig(out, dpi=130, bbox_inches="tight")
            print(f"  wrote {out}")


if __name__ == "__main__":
    main()
