"""raygen_kernel_ms: device ms a frame of the raygen kernel's launches
(ops/rays.generate_camera_rays_ids -> csrc/raygen.cu), the mean over the
ranks; None where the program has no such kernel."""


def read(r):
    return r.per_frame_ms("raygen")
