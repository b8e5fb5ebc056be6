"""PLY mesh loader (ascii + binary little/big endian).

Replaces the reference's `ply-rs`-based loader (src/shapes/plymesh.rs).
Supports vertex properties x/y/z, nx/ny/nz, u/v (or s/t), and triangle/quad
faces via `vertex_indices` lists (quads are split into two triangles).
The port's copy of ``pbrt_tpu/scene/ply.py``.
"""
from __future__ import annotations

import struct

import numpy as np

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path):
    """Returns dict with 'p' (V,3), optional 'n' (V,3), 'uv' (V,2), 'indices' (T,3)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], parts[3], parts[2]))
                else:
                    elements[-1][2].append((parts[2], parts[1], None))
            elif parts[0] == "end_header":
                break
        body = f.read()

    verts = {}
    faces = []
    if fmt == "ascii":
        toks = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: np.empty(count, dtype=np.float64) for p in props}
                for i in range(count):
                    for pname, _t, _l in props:
                        cols[pname][i] = float(toks[ti]); ti += 1
                verts = cols
            elif name == "face":
                for _ in range(count):
                    n = int(toks[ti]); ti += 1
                    idx = [int(toks[ti + k]) for k in range(n)]
                    ti += n
                    _add_face(faces, idx)
            else:
                for _ in range(count):
                    for _pname, _t, ltype in props:
                        if ltype is not None:
                            n = int(toks[ti]); ti += 1; ti += n
                        else:
                            ti += 1
    else:
        endian = "<" if fmt == "binary_little_endian" else ">"
        pos = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                fmt_str = endian + "".join(_TYPES[p[1]][0] for p in props)
                rec = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype([(p[0], endian + _TYPES[p[1]][0]) for p in props]), count=count, offset=pos)
                verts = {p[0]: arr[p[0]].astype(np.float64) for p in props}
                pos += rec * count
            elif name == "face":
                for _ in range(count):
                    for _pname, etype, ltype in props:
                        if ltype is not None:
                            (n,) = struct.unpack_from(endian + _TYPES[ltype][0], body, pos)
                            pos += _TYPES[ltype][1]
                            esz = _TYPES[etype][1]
                            idx = struct.unpack_from(endian + _TYPES[etype][0] * n, body, pos)
                            pos += esz * n
                            _add_face(faces, idx)
                        else:
                            pos += _TYPES[etype][1]
            else:
                for _ in range(count):
                    for _pname, etype, ltype in props:
                        if ltype is not None:
                            (n,) = struct.unpack_from(endian + _TYPES[ltype][0], body, pos)
                            pos += _TYPES[ltype][1] + _TYPES[etype][1] * n
                        else:
                            pos += _TYPES[etype][1]

    out = {}
    if not all(k in verts for k in ("x", "y", "z")):
        raise ValueError(f"{path}: PLY has no x/y/z vertex positions")
    out["p"] = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1)
    if all(k in verts for k in ("nx", "ny", "nz")):
        out["n"] = np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=-1)
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in verts and vkey in verts:
            out["uv"] = np.stack([verts[ukey], verts[vkey]], axis=-1)
            break
    out["indices"] = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return out


def _add_face(faces, idx):
    if len(idx) == 3:
        faces.append(list(idx))
    elif len(idx) == 4:
        faces.append([idx[0], idx[1], idx[2]])
        faces.append([idx[0], idx[2], idx[3]])
    elif len(idx) > 4:  # fan triangulation
        for k in range(1, len(idx) - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
