"""The trace's probes on the triangle kinds, against the JAX package: the
dense icosphere's triangle tree and the instanced meshes' trees (the
cases and tolerances of tests/test_torch_probes.py, whose checks these
are)."""

import pytest

pytest.importorskip("torch")

from test_torch_probes import (check_depth_out, check_radiance,  # noqa: E402
                               check_stats_exact)


@pytest.mark.parametrize("name", ["ico2", "tlas"])
def test_depth_out_matches_pallas(name):
    check_depth_out(name)


@pytest.mark.parametrize("name", ["ico2", "tlas"])
def test_collect_stats_matches_pallas(name):
    """The icosphere's triangle tree; the instances' mesh trees."""
    check_stats_exact(name)


def test_probes_leave_the_radiance_alone():
    check_radiance("tlas")
