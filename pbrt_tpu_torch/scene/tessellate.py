"""Host tessellation for curve / loopsubdiv / nurbs / heightfield shapes.

The reference intersects curves analytically by recursive subdivision
(src/shapes/curve.rs) and converts loopsubdiv/nurbs/heightfield to triangle
meshes at creation time (src/shapes/loopsubdiv.rs, nurbs.rs,
heightfield.rs). As in the reference
(``pbrt_tpu/scene/tessellate.py``), all four become world-space TriangleMesh
records here.
"""
from __future__ import annotations

import logging

import numpy as np

from ..core.transform import Transform
from .host import TriangleMesh

log = logging.getLogger(__name__)


def _mesh_from_grid(pw, nw, nu, nv, reverse_orientation, swaps, uv=None):
    """Grid of (nu+1)x(nv+1) world-space points -> TriangleMesh."""
    idx = []
    for i in range(nu):
        for j in range(nv):
            a = i * (nv + 1) + j
            b = (i + 1) * (nv + 1) + j
            idx.append([a, b, b + 1])
            idx.append([a, b + 1, a + 1])
    if uv is None:
        uu, vv = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1), indexing="ij")
        uv = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    return TriangleMesh(
        p=pw.reshape(-1, 3),
        indices=np.asarray(idx, dtype=np.int32),
        n=None if nw is None else nw.reshape(-1, 3),
        uv=uv,
        reverse_orientation=reverse_orientation,
        transform_swaps_handedness=swaps,
    )


# ---------------------------------------------------------------------------
# Heightfield (src/shapes/heightfield.rs: nu x nv z-grid -> trianglemesh)
# ---------------------------------------------------------------------------


def tessellate_heightfield(o2w: Transform, nu: int, nv: int, pz, reverse_orientation: bool):
    pz = np.asarray(pz, dtype=np.float64).reshape(nu, nv)
    us = np.linspace(0, 1, nu)
    vs = np.linspace(0, 1, nv)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    p_obj = np.stack([uu, vv, pz], axis=-1).reshape(-1, 3)
    pw = o2w.xpoint(p_obj)
    idx = []
    for i in range(nu - 1):
        for j in range(nv - 1):
            a = i * nv + j
            b = (i + 1) * nv + j
            idx.append([a, b, b + 1])
            idx.append([a, b + 1, a + 1])
    uvg = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    return TriangleMesh(
        p=pw,
        indices=np.asarray(idx, dtype=np.int32),
        uv=uvg,
        reverse_orientation=reverse_orientation,
        transform_swaps_handedness=o2w.swaps_handedness(),
    )


# ---------------------------------------------------------------------------
# Bezier curves (src/shapes/curve.rs: flat / cylinder / ribbon)
# ---------------------------------------------------------------------------


def _bezier_eval(cp, u):
    """cp: (4, 3); u: (N,) -> points (N, 3), tangents (N, 3)."""
    u = u[:, None]
    b0 = (1 - u) ** 3
    b1 = 3 * u * (1 - u) ** 2
    b2 = 3 * u * u * (1 - u)
    b3 = u ** 3
    p = b0 * cp[0] + b1 * cp[1] + b2 * cp[2] + b3 * cp[3]
    d0 = 3 * (1 - u) ** 2
    d1 = 6 * u * (1 - u)
    d2 = 3 * u * u
    t = d0 * (cp[1] - cp[0]) + d1 * (cp[2] - cp[1]) + d2 * (cp[3] - cp[2])
    return p, t


def tessellate_curve(
    o2w: Transform,
    cp_obj,
    width0: float,
    width1: float,
    curve_type: str = "flat",
    normals=None,
    n_segments: int = 64,
    n_radial: int = 8,
    reverse_orientation: bool = False,
):
    """One cubic Bezier segment -> triangle ribbon/tube mesh.

    flat/ribbon: camera-independent two-sided strip oriented by normals
    (ribbon) or by an arbitrary stable frame (flat); cylinder: full tube.
    """
    cp = o2w.xpoint(np.asarray(cp_obj, dtype=np.float64).reshape(4, 3))
    u = np.linspace(0.0, 1.0, n_segments + 1)
    p, t = _bezier_eval(cp, u)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    widths = (1 - u) * width0 + u * width1

    # stable frame along the curve (rotation-minimizing-ish via propagation)
    frames = np.zeros((len(u), 3))
    ref = np.array([0.0, 0.0, 1.0]) if abs(t[0, 2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    n_prev = np.cross(t[0], ref)
    n_prev /= max(np.linalg.norm(n_prev), 1e-12)
    for i in range(len(u)):
        n_i = n_prev - t[i] * np.dot(n_prev, t[i])
        nrm = np.linalg.norm(n_i)
        if nrm < 1e-9:
            n_i = np.cross(t[i], ref)
            nrm = np.linalg.norm(n_i)
        n_i /= max(nrm, 1e-12)
        frames[i] = n_i
        n_prev = n_i

    if curve_type == "ribbon" and normals is not None:
        n0 = np.asarray(normals[0], dtype=np.float64)
        n1 = np.asarray(normals[1], dtype=np.float64)
        n0w = o2w.xnormal(n0[None, :])[0]
        n1w = o2w.xnormal(n1[None, :])[0]
        # slerp-ish between end normals (curve.rs ribbon normal interp)
        frames = (1 - u)[:, None] * n0w[None, :] + u[:, None] * n1w[None, :]
        frames /= np.maximum(np.linalg.norm(frames, axis=-1, keepdims=True), 1e-12)

    swaps = o2w.swaps_handedness()

    if curve_type == "cylinder":
        theta = np.linspace(0, 2 * np.pi, n_radial + 1)
        verts = []
        for i in range(len(u)):
            bt = np.cross(t[i], frames[i])
            ring = p[i] + 0.5 * widths[i] * (np.cos(theta)[:, None] * frames[i] + np.sin(theta)[:, None] * bt)
            verts.append(ring)
        pw = np.stack(verts)  # (S+1, n_radial+1, 3)
        return _mesh_from_grid(pw, None, n_segments, n_radial, reverse_orientation, swaps)

    # flat / ribbon strip: 2 verts per sample
    side = np.cross(t, frames)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
    left = p - 0.5 * widths[:, None] * side
    right = p + 0.5 * widths[:, None] * side
    pw = np.stack([left, right], axis=1)  # (S+1, 2, 3)
    nrm = np.broadcast_to(frames[:, None, :], pw.shape).copy()
    return _mesh_from_grid(pw, nrm, n_segments, 1, reverse_orientation, swaps)


# ---------------------------------------------------------------------------
# Loop subdivision (src/shapes/loopsubdiv.rs)
# ---------------------------------------------------------------------------


def loop_subdivide(o2w: Transform, n_levels: int, indices, p_obj, reverse_orientation: bool):
    """Loop subdivision surface -> limit triangle mesh.

    Index-array implementation of the reference's SDVertex/SDFace pointer
    algorithm: each level splits every triangle into 4, repositions even
    vertices by the Loop beta mask and odd (edge) vertices by the 3/8-1/8
    mask; the final positions are pushed to the limit surface.
    """
    v = np.asarray(p_obj, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(indices, dtype=np.int64).reshape(-1, 3)

    for _ in range(max(n_levels, 0)):
        nv = len(v)
        # edge -> midpoint index map
        edge_map: dict[tuple, int] = {}
        edge_faces: dict[tuple, list] = {}
        for fi, tri in enumerate(f):
            for e in range(3):
                a, b = int(tri[e]), int(tri[(e + 1) % 3])
                key = (min(a, b), max(a, b))
                edge_faces.setdefault(key, []).append((fi, tri[(e + 2) % 3]))

        new_pts = []
        for key, faces in edge_faces.items():
            a, b = key
            if len(faces) == 2:
                o1 = v[int(faces[0][1])]
                o2 = v[int(faces[1][1])]
                pt = 0.375 * (v[a] + v[b]) + 0.125 * (o1 + o2)
            else:  # boundary edge
                pt = 0.5 * (v[a] + v[b])
            edge_map[key] = nv + len(new_pts)
            new_pts.append(pt)

        # even (existing) vertex repositioning
        neighbors: dict[int, set] = {}
        boundary_nb: dict[int, set] = {}
        for key, faces in edge_faces.items():
            a, b = key
            neighbors.setdefault(a, set()).add(b)
            neighbors.setdefault(b, set()).add(a)
            if len(faces) == 1:
                boundary_nb.setdefault(a, set()).add(b)
                boundary_nb.setdefault(b, set()).add(a)

        v_new = v.copy()
        for vi in range(nv):
            nb = neighbors.get(vi, set())
            if vi in boundary_nb:
                bn = list(boundary_nb[vi])
                if len(bn) >= 2:
                    v_new[vi] = 0.75 * v[vi] + 0.125 * (v[bn[0]] + v[bn[1]])
                continue
            k = len(nb)
            if k == 0:
                continue
            if k == 3:
                beta = 3.0 / 16.0
            else:
                beta = 3.0 / (8.0 * k)
            v_new[vi] = (1 - k * beta) * v[vi] + beta * sum(v[j] for j in nb)

        faces_out = []
        for tri in f:
            a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
            ab = edge_map[(min(a, b), max(a, b))]
            bc = edge_map[(min(b, c), max(b, c))]
            ca = edge_map[(min(c, a), max(c, a))]
            faces_out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]

        v = np.vstack([v_new, np.asarray(new_pts)]) if new_pts else v_new
        f = np.asarray(faces_out, dtype=np.int64)

    pw = o2w.xpoint(v)
    return TriangleMesh(
        p=pw,
        indices=f.astype(np.int32),
        reverse_orientation=reverse_orientation,
        transform_swaps_handedness=o2w.swaps_handedness(),
    )


# ---------------------------------------------------------------------------
# NURBS (src/shapes/nurbs.rs: evaluate on a grid -> trianglemesh)
# ---------------------------------------------------------------------------


def _nurbs_basis(t, order, knots, n_ctrl):
    """Cox-de-Boor basis functions for all control points at params t (N,)."""
    t = np.asarray(t, dtype=np.float64)
    knots = np.asarray(knots, dtype=np.float64)
    deg = order - 1
    n = len(t)
    basis = np.zeros((n, n_ctrl + deg))
    # degree-0
    for i in range(n_ctrl + deg):
        basis[:, i] = (t >= knots[i]) & (t < knots[i + 1])
    # clamp the last parameter into the final non-degenerate span
    last = t >= knots[-1] - 1e-12
    for i in range(n_ctrl + deg):
        basis[last, i] = 0.0
    for i in range(n_ctrl + deg - 1, -1, -1):
        if knots[i] < knots[i + 1]:
            basis[last, i] = 1.0
            break
    for d in range(1, deg + 1):
        nb = np.zeros_like(basis)
        for i in range(n_ctrl + deg - d):
            den1 = knots[i + d] - knots[i]
            den2 = knots[i + d + 1] - knots[i + 1]
            t1 = np.where(den1 > 1e-12, (t - knots[i]) / max(den1, 1e-12), 0.0) * basis[:, i]
            t2 = np.where(den2 > 1e-12, (knots[i + d + 1] - t) / max(den2, 1e-12), 0.0) * basis[:, i + 1]
            nb[:, i] = t1 + t2
        basis = nb
    return basis[:, :n_ctrl]


def tessellate_nurbs(
    o2w: Transform,
    nu: int,
    uorder: int,
    uknots,
    u0: float,
    u1: float,
    nv: int,
    vorder: int,
    vknots,
    v0: float,
    v1: float,
    p_ctrl,
    pw_ctrl,
    reverse_orientation: bool,
    diceu: int = 30,
    dicev: int = 30,
):
    """Evaluate the NURBS surface on a (diceu x dicev) grid."""
    if pw_ctrl is not None:
        cp = np.asarray(pw_ctrl, dtype=np.float64).reshape(nu * nv, 4)
        ctrl = cp[:, :3] * cp[:, 3:4]
        w = cp[:, 3]
    else:
        ctrl = np.asarray(p_ctrl, dtype=np.float64).reshape(nu * nv, 3)
        w = np.ones(nu * nv)
    ctrl4 = np.concatenate([ctrl, w[:, None]], axis=-1).reshape(nv, nu, 4)  # pbrt stores v-major

    us = np.linspace(u0, u1, diceu)
    vs = np.linspace(v0, v1, dicev)
    bu = _nurbs_basis(us, uorder, uknots, nu)  # (diceu, nu)
    bv = _nurbs_basis(vs, vorder, vknots, nv)  # (dicev, nv)
    # surface points: S(u,v) = sum_j sum_i bu_i bv_j C[j,i]
    s = np.einsum("ui,vj,jik->uvk", bu, bv, ctrl4)
    pts = s[..., :3] / np.maximum(s[..., 3:4], 1e-12)
    pw = o2w.xpoint(pts.reshape(-1, 3))
    uu, vv = np.meshgrid(np.linspace(0, 1, diceu), np.linspace(0, 1, dicev), indexing="ij")
    uvg = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    return _mesh_from_grid(pw.reshape(diceu, dicev, 3), None, diceu - 1, dicev - 1, reverse_orientation, o2w.swaps_handedness(), uvg)
