"""Transforms, rays and AABB math.

Replaces the reference's glm-based Transform/Ray/AABB layer
(src/core/geometry.h).  Unlike the reference, transforms
exist only at scene-build time: primitives are baked to world space before
they reach a kernel (the approach of the reference's own fastest backend,
OptiX: spheres to center+radius, quads to corner+edge vectors —
src/backend/optix/renderer.cpp:643-671), so kernels never
carry 4x4 matrices.

Host-side (numpy) because it only runs during scene construction.
"""

from __future__ import annotations

import numpy as np


def rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def euler_xyz(angles_rad) -> np.ndarray:
    """Rotation matrix R = Rx @ Ry @ Rz, matching glm::eulerAngleXYZ used by
    Scene::MakeTransform (src/core/scene.cpp:9-17,
    geometry.h:92-99)."""
    x, y, z = angles_rad
    return rot_x(x) @ rot_y(y) @ rot_z(z)


def make_transform(scale=(1.0, 1.0, 1.0), euler_deg=(0.0, 0.0, 0.0),
                   translation=(0.0, 0.0, 0.0)) -> np.ndarray:
    """4x4 affine M = T * R * S (reference Transform::Set,
    src/core/geometry.h:92-99)."""
    s = np.asarray(scale, dtype=np.float64)
    t = np.asarray(translation, dtype=np.float64)
    r = euler_xyz(np.radians(np.asarray(euler_deg, dtype=np.float64)))
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r * s[None, :]  # R @ diag(s)
    m[:3, 3] = t
    return m


def transform_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    return m[:3, :3] @ p + m[:3, 3]


def transform_vector(m: np.ndarray, v) -> np.ndarray:
    v = np.asarray(v, dtype=np.float64)
    return m[:3, :3] @ v


def transform_normal(inv_m: np.ndarray, n) -> np.ndarray:
    """Normal transform: normalize((M^-1)^T n)
    (src/core/geometry.h:138-142)."""
    n = np.asarray(n, dtype=np.float64)
    out = inv_m[:3, :3].T @ n
    return out / np.linalg.norm(out)


def uniform_scale_of(m: np.ndarray, atol: float = 1e-6) -> float:
    """Extract the uniform scale factor of M's linear part; raises if the
    scale is non-uniform (baked sphere primitives require uniform scale, as
    does the reference's own OptiX bake,
    src/backend/optix/renderer.cpp:643-647)."""
    lin = m[:3, :3]
    lens = np.linalg.norm(lin, axis=0)
    if not (np.allclose(lens[0], lens[1], atol=atol)
            and np.allclose(lens[0], lens[2], atol=atol)):
        raise ValueError(f"non-uniform scale {lens} not supported for baked spheres")
    return float(lens[0])


# ----------------------------------------------------------------------------
# AABB helpers (host-side, for LBVH builds). Device-side AABB slab tests live
# in accel/.
# ----------------------------------------------------------------------------

def aabb_union(a_min, a_max, b_min, b_max):
    return np.minimum(a_min, b_min), np.maximum(a_max, b_max)


def sphere_aabb(center: np.ndarray, radius: np.ndarray):
    """(N,3),(N,) -> (N,3),(N,3) world AABBs."""
    r = radius[:, None]
    return center - r, center + r


def quad_aabb(center: np.ndarray, edge_u: np.ndarray, edge_v: np.ndarray,
              pad: float = 1e-2):
    """World AABBs of baked quads, padded like the reference's OptiX quad
    GAS (+-0.01, src/backend/optix/renderer.cpp:768-831)."""
    ext = np.abs(edge_u) + np.abs(edge_v) + pad
    return center - ext, center + ext


def triangle_aabb(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    mn = np.minimum(np.minimum(v0, v1), v2)
    mx = np.maximum(np.maximum(v0, v1), v2)
    return mn, mx
