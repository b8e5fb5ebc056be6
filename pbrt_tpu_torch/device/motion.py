"""Exact per-ray animated-transform evaluation (motion blur).

The port's counterpart of ``pbrt_tpu/device/motion.py`` (:31-119). The
reference applies motion per ray: AnimatedTransform decomposes both
keyframe matrices into T / R (a quaternion) / S (transform.rs:1442
decompose) and interpolates the parts at the ray's shutter time (:1493:
translation lerp, rotation slerp, scale lerp):

    M(dt) = T(dt) . R(slerp(q0, q1, dt)) . S(dt)          (3x4)

The builder decomposes each distinct animated shutter CTM pair into a group
row (q0, q1 sign-aligned, theta their angle) and gives each prim a compose
constant C:

    triangles:  p(t) = M(dt) . C . p_world0   with C = M0^-1
    quadrics:   w2o(t) = C . M(dt)^-1         with C = w2o0 . M0

Group 0 is the identity's decomposition: static prims go through the same
math and come out within an ulp of their rows, as in the reference.

Every function here writes its products and sums out component by
component, in the order of the motion instantiation of csrc/bvh_walk.cu
(no matmul, einsum or reduction, whose order a library may change), so that
the walk's plain twin (device/bvh_walk.py) and the kernel agree bit for
bit on the card. Matrices are (..., 3, 4) tensors; q (..., 4) is wxyz.
"""
from __future__ import annotations

import torch

NLERP_THETA = 0.0317  # below it slerp is the normalised lerp (AnimatedTransform's cos > 0.9995)


def _slerp(q0, q1, theta, dt):
    """slerp(q0, q1, dt), the nlerp for nearly parallel quaternions
    (quaternion.rs slerp), normalised with the norm clamped at 1e-12."""
    near = theta < NLERP_THETA
    st = torch.sin(torch.where(near, 1.0, theta))
    w0 = torch.where(near, 1.0 - dt, torch.sin((1.0 - dt) * theta) / st)
    w1 = torch.where(near, dt, torch.sin(dt * theta) / st)
    q = w0[..., None] * q0 + w1[..., None] * q1
    n2 = ((q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]) + q[..., 3] * q[..., 3]
    return q / torch.clamp(torch.sqrt(n2), min=1e-12)[..., None]


def _quat_to_matrix(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation (quaternion.rs to_transform)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def _mat3(a, b):
    """(..., 3, 3) a @ b, each entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j."""
    return torch.stack([torch.stack([(a[..., i, 0] * b[..., 0, j] + a[..., i, 1] * b[..., 1, j])
                                     + a[..., i, 2] * b[..., 2, j] for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def _mat3_vec(a, v):
    """(..., 3, 3) a applied to (..., 3) v, in _mat3's order."""
    return torch.stack([(a[..., i, 0] * v[..., 0] + a[..., i, 1] * v[..., 1]) + a[..., i, 2] * v[..., 2]
                        for i in range(3)], dim=-1)


def eval_anim(an, gid, dt):
    """The interpolated transform M(dt) (..., 3, 4) = T(dt) . R . S of group
    `gid` (int64, any shape) at shutter fraction dt (float32, gid's shape;
    transform.rs:1493). an: the scene's anim tables."""
    q = _slerp(an["q0"][gid], an["q1"][gid], an["theta"][gid], dt)
    rot = _quat_to_matrix(q)
    w = dt[..., None, None]
    s = (1.0 - w) * an["s0"][gid] + w * an["s1"][gid]
    rs = _mat3(rot, s)
    t = (1.0 - dt[..., None]) * an["t0"][gid] + dt[..., None] * an["t1"][gid]
    return torch.cat([rs, t[..., :, None]], dim=-1)


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


def _affine_inverse(m):
    """(..., 3, 4) affine -> its inverse by the adjugate, |det| clamped at
    1e-30."""
    a0, a1, a2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    c0 = _cross(a1, a2)
    c1 = _cross(a2, a0)
    c2 = _cross(a0, a1)
    det = (a0[..., 0] * c0[..., 0] + a0[..., 1] * c0[..., 1]) + a0[..., 2] * c0[..., 2]
    det = torch.where(det.abs() < 1e-30, 1e-30, det)[..., None, None]
    inv = torch.stack([c0, c1, c2], dim=-2) / det
    ti = -_mat3_vec(inv, m[..., :, 3])
    return torch.cat([inv, ti[..., :, None]], dim=-1)


def _compose(a, b):
    """a . b as affine transforms (b applied first)."""
    r = _mat3(a[..., :3], b[..., :3])
    t = _mat3_vec(a[..., :3], b[..., :, 3]) + a[..., :, 3]
    return torch.cat([r, t[..., :, None]], dim=-1)


def xform_point(m, p):
    """(..., 3, 4) applied to the point (..., 3)."""
    return _mat3_vec(m[..., :3], p) + m[..., :, 3]


def motion_matrices(sa, prim_rows, dt, quadric=False):
    """The exact motion transform of prims `prim_rows` (int64) at dt (float32,
    broadcast against prim_rows): for a triangle G = M(dt) . C, which maps
    its shutter-open rows to time dt; for a quadric (quadric=True) its
    world-to-object C . M(dt)^-1."""
    prim_rows, dt = torch.broadcast_tensors(prim_rows, dt)
    m = eval_anim(sa.anim, sa.anim_gid[prim_rows].to(torch.int64), dt)
    c = sa.anim_c[prim_rows]
    if quadric:
        return _compose(c, _affine_inverse(m))
    return _compose(m, c)


def motion_quad(base, end, mid, time_b):
    """The keyframe motion of a table row (reference intersect._motion_quad
    :697): the lerp toward the shutter-close row, plus the quadratic arc
    term through the mid-shutter row when the motion rotates."""
    out = base + time_b * (end - base)
    if mid is not None:
        out = out + (time_b * (1.0 - time_b)) * ((4.0 * mid - 2.0 * base) - 2.0 * end)
    return out
