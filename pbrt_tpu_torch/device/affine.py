"""Explicit-arithmetic affine transforms for geometry.

The port's counterpart of ``pbrt_tpu/device/affine.py``: every transform is
written as multiply-adds in the reference's order (src/core/transform.rs
transform_point/vector/normal), so float32 results match it. ``m`` is a
(..., 3, 4) stack that broadcasts against (..., 3) points or vectors (the
brute-force intersector passes m=(1, P, 3, 4) against p=(R, 1, 3)).
"""
from __future__ import annotations

import torch


def xf_point(m, p):
    """Affine point transform: rows 0..2 of m applied to p, plus translation."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3],
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3],
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3],
    ], dim=-1)


def xf_vector(m, v):
    """Linear (no-translation) transform of a direction."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], dim=-1)


def xf_vector_t(m, v):
    """Transpose transform, out_i = sum_j m[j, i] v_j: normals through the
    inverse matrix's transpose."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 1, 0] * y + m[..., 2, 0] * z,
        m[..., 0, 1] * x + m[..., 1, 1] * y + m[..., 2, 1] * z,
        m[..., 0, 2] * x + m[..., 1, 2] * y + m[..., 2, 2] * z,
    ], dim=-1)
