"""The port's example scripts (parallelraytracing_tpu_torch/examples/)
run on the CPU at their --quick sizes and write their PNGs, each of which
decodes to a finite image that is neither all black nor one colour."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from parallelraytracing_tpu_torch.examples import (animated_refit,  # noqa: E402
                                                   interactive_session,
                                                   render_showcase)
from parallelraytracing_tpu_torch.utils import png  # noqa: E402

EXAMPLES = {
    "animated_refit": (animated_refit, ["animated_refit_f0.png",
                                        "animated_refit_f1.png"]),
    "render_showcase": (render_showcase, [
        "cornell.png", "cornell_nee_8spp.png", "material_test.png",
        "random_balls_large.png", "bunny.png", "dragon.png",
        "multimesh_tlas.png", "texture_demo_dof.png"]),
    "interactive_session": (interactive_session, [
        "interactive_bunny_preview.png", "interactive_bunny_settled.png",
        "interactive_texture_demo_preview.png",
        "interactive_texture_demo_settled.png"]),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_quick_on_cpu(tmp_path, name):
    mod, pngs = EXAMPLES[name]
    assert mod.main(["--device", "cpu", "--quick", "--out-dir",
                     str(tmp_path)]) == 0
    for f in pngs:
        img = png.read_png(str(tmp_path / f))
        assert img.ndim == 3 and img.shape[2] in (3, 4)
        rgb = img[..., :3].reshape(-1, 3)
        assert rgb.max() > 0 and len(np.unique(rgb, axis=0)) > 1, f
