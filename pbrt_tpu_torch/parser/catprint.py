"""--cat / --toply: re-emit a parsed scene as formatted .pbrt statements.

Mirrors the reference's cat/to_ply printing path (src/core/pbrt.rs Options
cat/to_ply; the directive printers live alongside the API methods in
src/core/api.rs — each pbrt_* call prints itself when options.cat is set).
With to_ply, large inline triangle meshes are written to mesh_%05d.ply and
replaced by plymesh references, exactly the reference's behavior for
shrinking scene files. The port's copy of ``pbrt_tpu/parser/catprint.py``.
"""
from __future__ import annotations

import numpy as np

from ..core.paramset import ParamSet
from .parser import Directive

_INDENTERS = {"AttributeBegin", "TransformBegin", "ObjectBegin", "WorldBegin"}
_DEDENTERS = {"AttributeEnd", "TransformEnd", "ObjectEnd", "WorldEnd"}
_TOPLY_MIN_TRIS = 500


def _fmt_num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(round(f, 9))


def _fmt_values(t: str, values) -> str:
    if t in ("string", "texture"):
        return " ".join(f'"{v}"' for v in values)
    if t == "bool":
        return " ".join('"true"' if v else '"false"' for v in values)
    arr = np.asarray(values).ravel()
    if t == "integer":
        return " ".join(str(int(v)) for v in arr)
    return " ".join(_fmt_num(v) for v in arr)


def format_params(ps: ParamSet | None) -> str:
    if ps is None or not ps.params:
        return ""
    out = []
    for (t, name), values in ps.params.items():
        out.append(f'"{t} {name}" [ {_fmt_values(t, values)} ]')
    return " " + " ".join(out)


def format_directive(d: Directive) -> str:
    parts = [d.name]
    parts += [f'"{a}"' if isinstance(a, str) else _fmt_num(a) for a in d.args]
    return " ".join(parts) + format_params(d.params)


def _write_ply(path: str, p: np.ndarray, indices: np.ndarray, n=None, uv=None, double: bool = False) -> None:
    """Minimal binary-little-endian PLY writer (plymesh.rs counterpart).
    double: positions, normals and UVs as float64 ("property double"), so a
    mesh made in float64 reads back bit for bit; --toply writes float32, as
    the reference does."""
    nv = len(p)
    pt, ft = ("double", "<f8") if double else ("float", "<f4")
    props = [f"property {pt} x", f"property {pt} y", f"property {pt} z"]
    cols = [np.asarray(p, ft)]
    if n is not None and len(n) == nv:
        props += [f"property {pt} nx", f"property {pt} ny", f"property {pt} nz"]
        cols.append(np.asarray(n, ft))
    if uv is not None and len(uv) == nv:
        props += [f"property {pt} u", f"property {pt} v"]
        cols.append(np.asarray(uv, ft))
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {nv}\n" + "\n".join(props) + "\n"
        f"element face {len(indices)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    vert = np.zeros(nv, dtype=[(f"c{i}", c.dtype, c.shape[1]) for i, c in enumerate(cols)])
    for i, c in enumerate(cols):
        vert[f"c{i}"] = c
    face = np.zeros(len(indices), dtype=[("n", "u1"), ("i", "<i4", 3)])
    face["n"] = 3
    face["i"] = np.asarray(indices, np.int32).reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vert.tobytes())
        f.write(face.tobytes())


def cat_scene(directives, to_ply: bool = False, out=None, ply_dir: str = ".") -> int:
    """Pretty-print the directive stream; returns the count printed.

    to_ply: trianglemesh shapes with >= 500 triangles are exported to
    mesh_%05d.ply and re-emitted as plymesh references."""
    import os
    import sys

    out = out or sys.stdout
    indent = 0
    n_ply = 0
    for d in directives:
        if d.name in _DEDENTERS:
            indent = max(indent - 1, 0)
        if (
            to_ply
            and d.name == "Shape"
            and d.args
            and d.args[0] == "trianglemesh"
            and d.params is not None
        ):
            idx = d.params.params.get(("integer", "indices"))
            p = d.params.params.get(("point3", "P"))
            if idx is not None and len(np.ravel(idx)) // 3 >= _TOPLY_MIN_TRIS and p is not None:
                fname = f"mesh_{n_ply:05d}.ply"
                n_ply += 1
                _write_ply(
                    os.path.join(ply_dir, fname),
                    np.asarray(p).reshape(-1, 3),
                    np.asarray(idx).reshape(-1, 3),
                    n=d.params.params.get(("normal", "N")),
                    uv=None if d.params.params.get(("point2", "uv")) is None else np.asarray(d.params.params.get(("point2", "uv"))).reshape(-1, 2),
                )
                rest = ParamSet(params={k: v for k, v in d.params.params.items() if k[1] not in ("indices", "P", "N", "uv", "st")})
                d = Directive(name="Shape", args=["plymesh"], params=rest, line=d.line)
                d.params.add("string", "filename", [fname])
        out.write("    " * indent + format_directive(d) + "\n")
        if d.name in _INDENTERS:
            indent += 1
    return n_ply
