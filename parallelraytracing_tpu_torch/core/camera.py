"""Pinhole camera (the counterpart of ``parallelraytracing_tpu.core.camera``).

Replicates the reference Camera's ray model (src/core/camera.h:6-155):
a vertical FoV of 1 radian (tanFovY = tan(0.5), camera.h:111), Y-flipped
NDC, camera looking down -Z.  The camera is tiny host state (numpy); ray
generation on the device is a function of its packed parameter vector
(``ray_params``, consumed by ops/rays.py).  The interactive orbit controls
belong with the viewer and are not in this port yet (ROADMAP Queue 1
item 17).
"""

from __future__ import annotations

import numpy as np

Y_AXIS = np.array([0.0, 1.0, 0.0])


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


class Camera:
    def __init__(self, position, front, width: float, height: float,
                 focal: float = 1.0):
        self.position = np.asarray(position, dtype=np.float64)
        self.front = _normalize(np.asarray(front, dtype=np.float64))
        self.right = _normalize(np.cross(self.front, Y_AXIS))
        self.up = _normalize(np.cross(self.right, self.front))
        self.width = float(width)
        self.height = float(height)
        self.focal = float(focal)

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


def default_camera(width: int, height: int) -> Camera:
    """The viewer's startup camera: eye (5,5,8) looking at the origin
    (src/main.cpp:142-150)."""
    center = np.array([5.0, 5.0, 8.0])
    focus = np.zeros(3)
    return Camera(center, focus - center, float(width), float(height), 100.0)
