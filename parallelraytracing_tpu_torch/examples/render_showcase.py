"""Render the BASELINE milestone configurations, the counterpart of the
repository's ``examples/render_showcase.py``.

The reference's bunny and dragon PLYs are not in the repository, so
their scenes take icospheres built here and written as PLYs: level 5
(20,480 triangles) for the bunny, level 7 (327,680: the stream route) for
the dragon; the multimesh scene takes the level-5 icosphere for the
bunny and the 20-triangle icosahedron.  The feline and hand scenes of
the JAX script are left out (no stand-in mesh).  Engines: the fused
kernel engines on the card; with --device cpu their plain PyTorch
versions (slow: use --quick).

Run:  python -m parallelraytracing_tpu_torch.examples.render_showcase --device cuda
      python -m parallelraytracing_tpu_torch.examples.render_showcase --device cpu --quick
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true",
                   help="1/8 of each size, 2 frames, icospheres of level 2 "
                        "and 3 for the bunny and the dragon (a smoke test)")
    p.add_argument("--out-dir", default="build/examples")
    args = p.parse_args(argv)

    from parallelraytracing_tpu_torch import (Camera, Film, RenderConfig,
                                              Scene, ScenePreset,
                                              create_renderer,
                                              default_camera)
    from parallelraytracing_tpu_torch.core.mesh import (Mesh, icosphere,
                                                        load_ply, write_ply)
    scale = 0.125 if args.quick else 1.0
    bunny_level, dragon_level = (2, 3) if args.quick else (5, 7)
    os.makedirs(args.out_dir, exist_ok=True)

    def render(name, scene, eye, look, engine, w, h, frames, depth=10,
               **cfg_kw):
        w, h = max(8, int(w * scale)), max(8, int(h * scale))
        frames = 2 if args.quick else frames
        cfg = RenderConfig(width=w, height=h, max_depth=depth, seed=0,
                           **cfg_kw)
        if eye is None:
            cam = default_camera(w, h)
        else:
            eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
            cam = Camera(eye, look - eye, float(w), float(h), 100.0)
        film = Film(w, h, args.device)
        r = create_renderer(engine, args.device)
        t0 = time.perf_counter()
        r.init(film, scene, cam, cfg)
        for _ in range(frames):
            r.progressive_render()
        img = film.hdr_average()
        if not bool(img.isfinite().all()) or float(img.max()) <= 0.0:
            raise RuntimeError(f"{name}: not finite or all black")
        path = os.path.join(args.out_dir, f"{name}.png")
        film.save_png(path)
        print(f"{name:24s} {engine:16s} {w}x{h} {frames}f "
              f"{time.perf_counter() - t0:6.1f}s -> {path}", flush=True)

    def mesh(level: int) -> Mesh:
        """The icosphere of `level` through a PLY, as a user's mesh loads."""
        path = os.path.join(args.out_dir, f"icosphere{level}.ply")
        write_ply(path, icosphere(level))
        return load_ply(path)

    # config 1: Cornell, 256x256; with NEE at 8 frames
    render("cornell", Scene(ScenePreset.CORNELL), None, None, "fused",
           256, 256, 64)
    render("cornell_nee_8spp", Scene(ScenePreset.CORNELL), None, None,
           "fused", 256, 256, 8, nee=True)
    render("material_test", Scene(ScenePreset.MATERIAL_TEST), None, None,
           "fused", 512, 288, 64)
    # the headline scene, 809 primitives
    render("random_balls_large", Scene(ScenePreset.RANDOM_BALLS_LARGE),
           (30.0, 18.0, 30.0), (0.0, 0.0, 0.0), "fused", 640, 360, 32,
           depth=20)

    # config 2: the bunny (an icosphere) on a ground quad
    s = Scene(preset=None)
    s.add_mesh(mesh(bunny_level), s.add_lambertian((0.75, 0.65, 0.5)),
               ((8, 8, 8), (0, 180, 0), (0, 8.0, 0)))
    s.add_quad(100, 100, s.add_lambertian((0.5, 0.5, 0.5)), None)
    s.add_sphere(3.0, s.add_emissive((12, 12, 12)),
                 ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
    render("bunny", s, (0.0, 14.0, 28.0), (0.0, 7.0, 0.0), "wavefront_fused",
           512, 512, 8, depth=6)

    # config 3: the dragon (a big icosphere) in metal, a glass sphere
    s = Scene(preset=None)
    s.add_mesh(mesh(dragon_level), s.add_metal((0.8, 0.6, 0.4), 0.15),
               ((10, 10, 10), (0, 200, 0), (0, 10, 0)))
    s.add_sphere(3.0, s.add_dielectric(1.5), ((1, 1, 1), (0, 0, 0), (-12, 3, 8)))
    s.add_quad(120, 120, s.add_lambertian((0.4, 0.4, 0.45)), None)
    s.add_sphere(4.0, s.add_emissive((10, 9, 8)),
                 ((1, 1, 1), (0, 0, 0), (15, 30, 15)))
    render("dragon", s, (0.0, 16.0, 32.0), (0.0, 8.0, 0.0), "wavefront_fused",
           512, 512, 8, depth=8)

    # config 4: the multimesh scene through instancing (7 instances of 2
    # unique meshes)
    ico = icosphere(0)
    ico = Mesh(ico.vertices, ico.indices)  # flat normals, as the PLY's
    bun = mesh(bunny_level)
    s = Scene(preset=None)
    body = s.add_lambertian((0.7, 0.6, 0.45))
    s.add_mesh_instances(bun, body, [((6, 6, 6), (0, 160, 0), (0, 6, 0)),
                                     ((3, 3, 3), (0, 40, 0), (-12, 3, 6))])
    glass = s.add_dielectric(1.5)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    s.add_mesh_instances(ico, glass, [((2.5,) * 3, (0, 30 * i, 0),
                                       (9 + 2.5 * i, 2.5, 8 - 3.0 * i))
                                      for i in range(3)])
    s.add_mesh_instances(ico, red, [((2,) * 3, (0, 15, 25), (-9, 2, 12)),
                                    ((1.5,) * 3, (30, 0, 0), (4, 1.5, 14))])
    s.add_quad(120, 120, s.add_lambertian((0.5, 0.5, 0.52)), None)
    s.add_sphere(3.5, s.add_emissive((11, 11, 10)),
                 ((1, 1, 1), (0, 0, 0), (14, 26, 14)))
    render("multimesh_tlas", s, (0.0, 12.0, 30.0), (0.0, 5.0, 0.0), "tlas",
           512, 288, 8, depth=6)

    # the extensions: checker textures and a thin lens on texture_demo
    render("texture_demo_dof", Scene(ScenePreset.TEXTURE_DEMO),
           (0.0, 4.0, 14.0), (0.0, 1.0, 0.0), "fused", 512, 288, 24, depth=8,
           lens_radius=0.35, focus_distance=12.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
