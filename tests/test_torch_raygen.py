"""The raygen kernel (csrc/raygen.cu) and its dispatch.

On the CPU (tier 1): ``generate_camera_rays_ids`` takes the plain chain
for CPU tensors and counts it on ``.plain``, with the reference's output;
the scalars the kernel is handed (``kernel_constants``) are the float32s
that PyTorch forms from the chain's Python scalars; the threefry
key-drawn routes never reach the dispatcher; ``--stats`` says which
raygen ran.

On a card (``cuda`` marker; skips without one): the kernel's o and d
equal the plain chain's on the card bit for bit (``torch.equal``) for
every variant, and one frame of ``fused``, ``wavefront_fused`` and
``sharded`` (1x1) launches it once, takes the plain chain never, and
leaves the film the bits it has with the plain chain.  This file imports
no JAX, so on the card it runs without the conftest:

    python -m pytest --noconftest tests/test_torch_raygen.py -m cuda
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import parallelraytracing_tpu_torch as T
from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm
from parallelraytracing_tpu_torch.ops import rays

SEED = 0xDEADBEEF  # a pixel seed above 2**31


def _camera(w, h, eye=(5.0, 5.0, 8.0), look=(0.0, 0.0, 0.0), yaw_deg=0.0):
    """The headline's camera at w x h, its front turned about +Y."""
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    a = math.radians(yaw_deg)
    rot = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                    [-math.sin(a), 0.0, math.cos(a)]])
    return T.Camera(eye, rot @ (look - eye), float(w), float(h), 100.0)


def _morton_ids(w, h, device):
    return torch.from_numpy(morton_pixel_perm(w, h)[0].copy()).to(device)


def _px_block(w, h, n_px, device):
    """The last px block of the sharded engine's slots at n_px blocks: the
    Morton ids, then ids past H*W (dummy rays) up to n_px * blk."""
    blk = -(-w * h // n_px)
    blk = -(-blk // 128) * 128
    slots = np.concatenate([morton_pixel_perm(w, h)[0],
                            np.arange(w * h, n_px * blk)]).astype(np.int32)
    return torch.from_numpy(slots[(n_px - 1) * blk:]).to(device)


#: (name, width, height, yaw, jitter, pix_seed, lens, qpt, ids)
VARIANTS = [
    ("headline_jitter", 1920, 1080, 0.0, True, SEED, None, None, "morton"),
    ("orbit_360p_yaw", 640, 360, 0.75, True, 12345, None, None, "morton"),
    ("no_jitter", 1920, 1080, 0.0, False, None, None, None, "morton"),
    ("qmc", 640, 360, 0.0, True, SEED, None, rays.halton_qpt(5), "morton"),
    ("lens", 640, 360, 0.0, True, SEED, (0.1, 8.0), None, "morton"),
    ("lens_qmc", 640, 360, 0.0, True, SEED, (0.1, 8.0), rays.halton_qpt(9),
     "morton"),
    ("lens_center", 640, 360, 0.0, False, None, (0.1, 8.0), None, "morton"),
    ("sharded_block", 1000, 563, 0.0, True, SEED, None, None, "px_block"),
]


def _inputs(w, h, yaw, ids, device):
    cam = torch.from_numpy(_camera(w, h, yaw_deg=yaw).ray_params()).to(device)
    idx = (_morton_ids(w, h, device) if ids == "morton"
           else _px_block(w, h, 4, device))
    return cam, idx


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_cpu_tensors_take_the_plain_chain(variant):
    _, _, _, yaw, jitter, pix_seed, lens, qpt, ids = variant
    w, h = 48, 27
    cam, idx = _inputs(w, h, yaw, ids, "cpu")
    launches, plain = (rays.generate_camera_rays_ids.launches,
                       rays.generate_camera_rays_ids.plain)
    o, d = rays.generate_camera_rays_ids(cam, w, h, idx, jitter, pix_seed,
                                         lens, qpt)
    assert rays.generate_camera_rays_ids.plain == plain + 1
    assert rays.generate_camera_rays_ids.launches == launches
    ro, rd = rays.generate_camera_rays_ids_reference(cam, w, h, idx, jitter,
                                                     pix_seed, lens, qpt)
    assert torch.equal(o, ro) and torch.equal(d, rd)


def _f32(x) -> np.float32:
    return np.float32(x.item() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("size", [(1920, 1080), (640, 360), (97, 55),
                                  (1000, 563)])
def test_kernel_constants_are_the_chain_scalars(size):
    """Each scalar the kernel is handed has the float32 bits PyTorch gives
    the chain's Python scalar: a float32 tensor times the scalar, or
    ATen's reciprocal of the float32 divisor on the card (its division by
    a CPU scalar)."""
    w, h = size
    lens, qpt = (0.1, 8.0), rays.halton_qpt(7)
    got = rays.kernel_constants(w, h, lens, qpt)
    one = torch.ones(1, dtype=torch.float32)
    want = [
        torch.tensor(float(w), dtype=torch.float32).reciprocal(),
        torch.tensor(float(h), dtype=torch.float32).reciprocal(),
        one * (w / h * rays.TAN_FOVY),
        *(one * float(q) for q in np.asarray(qpt, np.float32)),
        one * float(np.float32(lens[0])),
        one * float(np.float32(lens[1])),
    ]
    assert got.dtype == np.float32 and got.shape == (9,)
    assert got.tobytes() == np.array([_f32(x) for x in want],
                                     np.float32).tobytes()
    plain = rays.kernel_constants(w, h)
    assert plain[:3].tobytes() == got[:3].tobytes()
    assert not plain[3:].any()


def test_kernel_fixed_scalars_are_the_chain_floats():
    """The kernel's fixed scalars have the float32 bits the chain gives
    tan(1/2), its 2 pi and its focal clamp (a float32 tensor times the
    scalar, and clamp_min's bound): csrc/raygen.cu's hexadecimal
    literals, and bounce.cuh's kTwoPi, a float64 expression rounded."""
    csrc = Path(rays.__file__).parent.parent / "csrc"
    lit = {k: float.fromhex(v) for k, v in re.findall(
        r"constexpr float (k\w+) = (0x[0-9a-fp.+-]+)f;",
        (csrc / "raygen.cu").read_text())}
    two_pi = re.search(r"constexpr float kTwoPi = \(float\)\(([0-9.]+) \* "
                       r"([0-9.]+)\);", (csrc / "bounce.cuh").read_text())
    lit["kTwoPi"] = float(two_pi[1]) * float(two_pi[2])
    one = torch.ones(1, dtype=torch.float32)
    want = {"kTanFovy": one * rays.TAN_FOVY, "kTwoPi": one * rays._TWO_PI32,
            "kMinCos": torch.clamp_min(torch.zeros(1), rays._MIN_COS)}
    assert set(lit) == set(want)
    for name, x in want.items():
        assert np.float32(lit[name]).tobytes() == _f32(x).tobytes(), name


def test_key_drawn_routes_never_dispatch(monkeypatch):
    """generate_camera_rays_flat and generate_camera_rays with a threefry
    key (the megakernel, render_frame_sharded's plain route) stay plain
    PyTorch: neither the dispatcher nor the kernel is reached."""
    def refuse(*a, **k):
        raise AssertionError("the key-drawn route reached the dispatcher")

    monkeypatch.setattr(rays, "generate_camera_rays_ids", refuse)
    w, h = 16, 9
    cam = torch.from_numpy(_camera(w, h).ray_params())
    key = rays.sample_key(3, 1, 0)
    o, d = rays.generate_camera_rays_flat(cam, w, h, 5, 64, key, True,
                                          (0.1, 8.0))
    assert o.shape == d.shape == (64, 3)
    o, d = rays.generate_camera_rays(cam, w, h, key, True, (0.1, 8.0))
    assert o.shape == d.shape == (w * h, 3)
    o, d = rays.generate_camera_rays(cam, w, h, None, False)
    assert o.shape == d.shape == (w * h, 3)


def test_cli_stats_says_which_raygen_ran(tmp_path, capsys):
    from parallelraytracing_tpu_torch import cli
    out = tmp_path / "f.png"
    assert cli.main(["--device", "cpu", "--width", "16", "--height", "12",
                     "--depth", "2", "--frames", "3", "--stats", "--out",
                     str(out)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert "raygen: 0 kernel launches, 3 plain" in printed, printed


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raygen kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_kernel_equals_the_plain_chain_on_the_card(cuda, variant):
    _, w, h, yaw, jitter, pix_seed, lens, qpt, ids = variant
    cam, idx = _inputs(w, h, yaw, ids, cuda)
    launches = rays.generate_camera_rays_ids.launches
    o, d = rays.generate_camera_rays_ids(cam, w, h, idx, jitter, pix_seed,
                                         lens, qpt)
    assert rays.generate_camera_rays_ids.launches == launches + 1
    ro, rd = rays.generate_camera_rays_ids_reference(cam, w, h, idx, jitter,
                                                     pix_seed, lens, qpt)
    torch.cuda.synchronize()
    bad = (o != ro).any(1) | (d != rd).any(1)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {idx.numel()} rays differ; first at id "
        f"{int(idx[bad][0])}: o {o[bad][0].tolist()} / {ro[bad][0].tolist()}, "
        f"d {d[bad][0].tolist()} / {rd[bad][0].tolist()}")


def _card_renderer(engine, device):
    w, h = 320, 180
    cfg = T.RenderConfig(width=w, height=h, max_depth=4, seed=11)
    film = T.Film(w, h, device)
    r = T.create_renderer(engine, device)
    r.init(film, T.Scene(T.ScenePreset.RANDOM_BALLS_LARGE), _camera(w, h),
           cfg)
    return r, film


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "wavefront_fused", "sharded"])
def test_a_frame_launches_the_kernel_once(cuda, engine, monkeypatch):
    r, film = _card_renderer(engine, cuda)
    r.progressive_render()  # warm-up: the kernels load
    launches, plain = (rays.generate_camera_rays_ids.launches,
                       rays.generate_camera_rays_ids.plain)
    r.progressive_render()
    assert rays.generate_camera_rays_ids.launches == launches + 1
    assert rays.generate_camera_rays_ids.plain == plain
    # the same two frames with the plain chain in the kernel's place
    monkeypatch.setattr(rays, "_raygen_kernel", lambda *a: (
        rays.generate_camera_rays_ids_reference(*a)))
    r2, film2 = _card_renderer(engine, cuda)
    r2.progressive_render()
    r2.progressive_render()
    assert rays.generate_camera_rays_ids.launches == launches + 1
    torch.cuda.synchronize()
    assert torch.equal(film.accum, film2.accum)
    assert torch.equal(film.weights, film2.weights)

