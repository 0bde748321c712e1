"""Orbit camera (the counterpart of ``parallelraytracing_tpu.core.camera``).

Replicates the reference Camera (src/core/camera.h:6-155): a pinhole with
a vertical FoV of 1 radian (tanFovY = tan(0.5), camera.h:111), Y-flipped
NDC, looking down -Z, and the velocity-integrated orbit / translate / zoom
controls (camera.h:21-85) with smoothing off by default (camera.h:145).
The camera is tiny host state in float64 numpy, computed step for step as
the JAX package computes it, so the same calls give the same bits; ray
generation on the device is a function of its packed parameter vector
(``ray_params``, consumed by ops/rays.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

Y_AXIS = np.array([0.0, 1.0, 0.0])


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _rotation_about(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rodrigues rotation matrix (glm::rotate)."""
    a = _normalize(np.asarray(axis, dtype=np.float64))
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    x, y, z = a
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + s * k + (1 - c) * np.outer(a, a)


class Camera:
    """Orbit camera with the reference's control model: controls add to
    velocities (Rotate / Translate / Zoom, camera.h:21-38), which
    ``update(dt)`` integrates; with smoothing off a velocity is applied
    once, scaled by dt * smoothness, and zeroed (camera.h:40-85)."""

    def __init__(self, position, front, width: float, height: float,
                 focal: float = 1.0):
        self.position = np.asarray(position, dtype=np.float64)
        self.front = _normalize(np.asarray(front, dtype=np.float64))
        self.right = _normalize(np.cross(self.front, Y_AXIS))
        self.up = _normalize(np.cross(self.right, self.front))
        self.width = float(width)
        self.height = float(height)
        self.focal = float(focal)

        self.enable_smoothing = False
        self.smoothness = 8.0  # camera.h:148
        self._zoom_velocity = 0.0
        self._translation_velocity = np.zeros(2)
        self._rotation_velocity = np.zeros(2)  # degrees

    # ---------------------------------------------------------- controls
    def rotate(self, angle_x_deg: float, angle_y_deg: float) -> None:
        self._rotation_velocity += np.array([angle_x_deg, angle_y_deg])

    def translate(self, offset_x: float, offset_y: float) -> None:
        self._translation_velocity += np.array([offset_x, offset_y])

    def zoom(self, offset: float) -> None:
        self._zoom_velocity += offset

    def update(self, dt: float) -> bool:
        """Integrate the velocities; True if the camera moved (the caller
        then clears the film, main.cpp:506-511)."""
        moved = False

        if abs(self._zoom_velocity) > 1e-4:
            self.position = self.position + self.front * (
                self._zoom_velocity * dt * self.smoothness)
            self._zoom_velocity = (
                self._zoom_velocity * math.exp(-self.smoothness * dt)
                if self.enable_smoothing else 0.0)
            moved = True

        if np.linalg.norm(self._translation_velocity) > 1e-4:
            off = self._translation_velocity * dt * self.smoothness
            self.position = self.position + self.right * off[0] + self.up * off[1]
            self._translation_velocity = (
                self._translation_velocity * math.exp(-self.smoothness * dt)
                if self.enable_smoothing else np.zeros(2))
            moved = True

        if np.linalg.norm(self._rotation_velocity) > 1e-4:
            rot = self._rotation_velocity * dt * self.smoothness
            rx = _rotation_about(self.right, math.radians(rot[0]))
            ry = _rotation_about(Y_AXIS, math.radians(rot[1]))
            r = rx @ ry
            self.position = r @ self.position
            self.front = _normalize(r @ self.front)
            self.right = _normalize(np.cross(self.front, Y_AXIS))
            self.up = _normalize(np.cross(self.right, self.front))
            self._rotation_velocity = (
                self._rotation_velocity * math.exp(-self.smoothness * dt)
                if self.enable_smoothing else np.zeros(2))
            moved = True

        return moved

    def get_view_projection(self) -> np.ndarray:
        """Camera::GetViewProjection (camera.h:87-94): right-handed lookAt
        view times a perspective of fovy 1 rad with a zero-to-one depth
        range, for rasterising consumers (the path tracer makes its rays
        directly)."""
        f = self.front
        r = self.right
        u = self.up
        eye = self.position
        view = np.eye(4)
        view[0, :3], view[1, :3], view[2, :3] = r, u, -f
        view[0, 3] = -np.dot(r, eye)
        view[1, 3] = -np.dot(u, eye)
        view[2, 3] = np.dot(f, eye)

        fovy, near, far = 1.0, 0.01, 1000.0
        aspect = self.width / self.height
        t = 1.0 / math.tan(fovy / 2.0)
        proj = np.zeros((4, 4))
        proj[0, 0] = t / aspect
        proj[1, 1] = t
        proj[2, 2] = far / (near - far)          # RH zero-to-one depth
        proj[2, 3] = -(far * near) / (far - near)
        proj[3, 2] = -1.0
        return proj @ view

    # --------------------------------------------------------- ray params
    def ray_params(self) -> np.ndarray:
        """Pack the camera into a flat f32 vector consumed on device:
        [position(3), right(3), up(3), front(3), width, height].

        Ray gen (ops/rays.py) reproduces GetCameraRay (camera.h:104-132):
          ndc_x = px/w*2-1 ; ndc_y = 1-py/h*2
          dir_cam = normalize(ndc_x*aspect*tan(.5), ndc_y*tan(.5), -1)
          dir_world = dir.x*right + dir.y*up + dir.z*(-front)
        """
        return np.concatenate([
            self.position, self.right, self.up, self.front,
            [self.width, self.height],
        ]).astype(np.float32)

    def get_camera_ray(self, px: float, py: float) -> Tuple[np.ndarray, np.ndarray]:
        """One ray (origin, unit direction) in float64 on the host: the
        reference for tests."""
        ndc_x = (px / self.width) * 2.0 - 1.0
        ndc_y = 1.0 - (py / self.height) * 2.0
        tan_fovy = math.tan(0.5)
        aspect = self.width / self.height
        d_cam = _normalize(np.array([ndc_x * aspect * tan_fovy,
                                     ndc_y * tan_fovy, -1.0]))
        d_world = _normalize(d_cam[0] * self.right + d_cam[1] * self.up
                             + d_cam[2] * -self.front)
        return self.position.copy(), d_world


def default_camera(width: int, height: int) -> Camera:
    """The viewer's startup camera: eye (5,5,8) looking at the origin
    (src/main.cpp:142-150)."""
    center = np.array([5.0, 5.0, 8.0])
    focus = np.zeros(3)
    return Camera(center, focus - center, float(width), float(height), 100.0)
