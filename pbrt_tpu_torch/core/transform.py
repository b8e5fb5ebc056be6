"""Host-side 4x4 transforms (NumPy, float64 internally, float32 export).

A copy of ``pbrt_tpu/core/transform.py`` (``Transform`` and the
``AnimatedTransform`` the scene API uses for moving shapes), so scene tables
come out bit-identical to the reference's.

Covers the capability surface of the reference's transform layer
(src/core/transform.rs): matrix+inverse pairs, the standard
factory constructors (translate/scale/rotate/look_at/orthographic/perspective),
and application to points/vectors/normals/bounds/rays.  Unlike the reference,
transforms only exist at scene-compile time on the host — the device side
receives pre-transformed world-space geometry plus per-quadric 3x4 matrices —
so there is no error-propagating transform path here; robust offsets are
handled in the device kernels with gamma bounds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def _mat_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


@dataclass(frozen=True)
class Transform:
    """A 4x4 matrix together with its inverse (reference: transform.rs:189)."""

    m: np.ndarray = field(default_factory=_mat_identity)
    m_inv: np.ndarray = field(default_factory=_mat_identity)

    def __post_init__(self):
        object.__setattr__(self, "m", np.asarray(self.m, dtype=np.float64).reshape(4, 4))
        object.__setattr__(self, "m_inv", np.asarray(self.m_inv, dtype=np.float64).reshape(4, 4))

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_matrix(m) -> "Transform":
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        return Transform(m, np.linalg.inv(m))

    @staticmethod
    def identity() -> "Transform":
        return Transform()

    @staticmethod
    def translate(delta) -> "Transform":
        d = np.asarray(delta, dtype=np.float64)
        m = np.eye(4)
        m[:3, 3] = d
        mi = np.eye(4)
        mi[:3, 3] = -d
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z) -> "Transform":
        m = np.diag([x, y, z, 1.0]).astype(np.float64)
        mi = np.diag([1.0 / x, 1.0 / y, 1.0 / z, 1.0]).astype(np.float64)
        return Transform(m, mi)

    @staticmethod
    def rotate_x(deg) -> "Transform":
        s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
        m = np.eye(4)
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
        return Transform(m, m.T)

    @staticmethod
    def rotate_y(deg) -> "Transform":
        s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
        m = np.eye(4)
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        return Transform(m, m.T)

    @staticmethod
    def rotate_z(deg) -> "Transform":
        s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
        m = np.eye(4)
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
        return Transform(m, m.T)

    @staticmethod
    def rotate(deg, axis) -> "Transform":
        """Rotation of `deg` degrees about an arbitrary axis (transform.rs:311)."""
        a = np.asarray(axis, dtype=np.float64)
        a = a / np.linalg.norm(a)
        s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
        m = np.eye(4)
        x, y, z = a
        m[0, 0] = x * x + (1 - x * x) * c
        m[0, 1] = x * y * (1 - c) - z * s
        m[0, 2] = x * z * (1 - c) + y * s
        m[1, 0] = x * y * (1 - c) + z * s
        m[1, 1] = y * y + (1 - y * y) * c
        m[1, 2] = y * z * (1 - c) - x * s
        m[2, 0] = x * z * (1 - c) - y * s
        m[2, 1] = y * z * (1 - c) + x * s
        m[2, 2] = z * z + (1 - z * z) * c
        return Transform(m, m.T)

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """Camera-to-world transform (reference: transform.rs:355-383)."""
        eye = np.asarray(eye, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        d = look - eye
        d = d / np.linalg.norm(d)
        upn = up / np.linalg.norm(up)
        right = np.cross(upn, d)
        rn = np.linalg.norm(right)
        if rn < 1e-12:
            # up parallel to viewing direction: pick an arbitrary right vector.
            right = np.cross(np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 else np.array([1.0, 0.0, 0.0]), d)
            rn = np.linalg.norm(right)
        right = right / rn
        new_up = np.cross(d, right)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = new_up
        c2w[:3, 2] = d
        c2w[:3, 3] = eye
        return Transform(c2w, np.linalg.inv(c2w))

    @staticmethod
    def orthographic(znear, zfar) -> "Transform":
        return Transform.scale(1.0, 1.0, 1.0 / (zfar - znear)) @ Transform.translate([0.0, 0.0, -znear])

    @staticmethod
    def perspective(fov_deg, n, f) -> "Transform":
        """Perspective projection (transform.rs:397-411)."""
        persp = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, f / (f - n), -f * n / (f - n)],
                [0.0, 0.0, 1.0, 0.0],
            ]
        )
        inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) @ Transform.from_matrix(persp)

    # -- algebra ------------------------------------------------------------
    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def is_identity(self) -> bool:
        return np.allclose(self.m, np.eye(4), atol=1e-12)

    def swaps_handedness(self) -> bool:
        """Sign of the upper-3x3 determinant (transform.rs:638)."""
        return float(np.linalg.det(self.m[:3, :3])) < 0.0

    def has_scale(self) -> bool:
        for v in np.eye(3):
            la2 = float(np.sum(self.xvector(v) ** 2))
            if la2 < 0.999 or la2 > 1.001:
                return True
        return False

    # -- application (vectorized over leading axes) -------------------------
    def xpoint(self, p) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        if np.any(np.abs(w - 1.0) > 1e-9):
            r = r / w[..., None] if r.ndim > 1 else r / w
        return r

    def xvector(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float64)
        return v @ self.m[:3, :3].T

    def xnormal(self, n) -> np.ndarray:
        n = np.asarray(n, dtype=np.float64)
        return n @ self.m_inv[:3, :3]

    def xbounds(self, lo, hi) -> tuple[np.ndarray, np.ndarray]:
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        corners = np.array([[lo[i] if (k >> i) & 1 == 0 else hi[i] for i in range(3)] for k in range(8)])
        wc = self.xpoint(corners)
        return wc.min(axis=0), wc.max(axis=0)

    def key(self) -> bytes:
        """Hashable dedup key over matrix bytes (reference TransformCache, api.rs:406)."""
        return np.ascontiguousarray(self.m, dtype=np.float64).tobytes()


# ---------------------------------------------------------------------------
# AnimatedTransform (src/core/transform.rs:687-…): matrix decomposition into
# translate / rotate(quaternion) / scale and slerp interpolation, which the
# scene API uses to bake a moving shape's mid-shutter keyframe.
# ---------------------------------------------------------------------------


def _decompose(m: np.ndarray):
    """M -> (T (3,), R quaternion (4,) wxyz, S (3,3)) (transform.rs
    decompose :1442; polar decomposition by Higham iteration)."""
    t = m[:3, 3].copy()
    upper = m[:3, :3].copy()
    r = upper.copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.abs(r_next - r).max() < 1e-8:
            r = r_next
            break
        r = r_next
    s = np.linalg.inv(r) @ upper
    return t, _quat_from_matrix(r), s


def _quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z) (quaternion.rs)."""
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(tr + 1.0) / 2.0
        s = 1.0 / (4.0 * w)
        q = np.array([w, (r[2, 1] - r[1, 2]) * s, (r[0, 2] - r[2, 0]) * s, (r[1, 0] - r[0, 1]) * s])
    else:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12))
        v = np.zeros(3)
        v[i] = 0.5 * s
        s = 0.5 / s
        w = (r[k, j] - r[j, k]) * s
        v[j] = (r[j, i] + r[i, j]) * s
        v[k] = (r[k, i] + r[i, k]) * s
        q = np.array([w, v[0], v[1], v[2]])
    return q / np.linalg.norm(q)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass(frozen=True)
class AnimatedTransform:
    """Two-keyframe rigid+scale interpolation over [start_time, end_time]."""

    start: Transform
    end: Transform
    start_time: float = 0.0
    end_time: float = 1.0

    @property
    def actually_animated(self) -> bool:
        return not np.allclose(self.start.m, self.end.m, atol=1e-9)

    def _parts(self):
        t0, q0, s0 = _decompose(np.asarray(self.start.m))
        t1, q1, s1 = _decompose(np.asarray(self.end.m))
        if float(np.dot(q0, q1)) < 0:
            q1 = -q1
        return (t0, q0, s0), (t1, q1, s1)

    def interpolate(self, time: float) -> Transform:
        """transform.rs AnimatedTransform::interpolate."""
        if not self.actually_animated or time <= self.start_time:
            return self.start
        if time >= self.end_time:
            return self.end
        dt = (time - self.start_time) / max(self.end_time - self.start_time, 1e-12)
        (t0, q0, s0), (t1, q1, s1) = self._parts()
        t = (1 - dt) * t0 + dt * t1
        cos_th = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
        if cos_th > 0.9995:
            q = (1 - dt) * q0 + dt * q1
        else:
            th = np.arccos(cos_th)
            q = (np.sin((1 - dt) * th) * q0 + np.sin(dt * th) * q1) / np.sin(th)
        q = q / np.linalg.norm(q)
        s = (1 - dt) * s0 + dt * s1
        m = np.eye(4)
        m[:3, :3] = _quat_to_matrix(q) @ s
        m[:3, 3] = t
        return Transform.from_matrix(m)
