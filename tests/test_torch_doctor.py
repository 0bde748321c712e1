"""The port's start-up probes (utils/diagnostics.py) and the CLI's
``--doctor`` on the CPU, against the JAX package's row layout.

Tolerances: exact.  ``run_diagnostics("cpu")`` has a row for torch, the
card, nvcc, triton, each kernel library's build (those five skipped on
the CPU and marked so), the native helpers and every engine the port
registers, each ok, with the JAX rows' keys (ok, detail, ms);
``working_engines("cpu")`` lists every engine; ``--doctor --device cpu``
exits 0 and prints every row; ``--stats`` prints the timer's summary.
"""

import pytest

torch = pytest.importorskip("torch")

import parallelraytracing_tpu_torch as T  # noqa: E402
from parallelraytracing_tpu_torch import cli  # noqa: E402
from parallelraytracing_tpu_torch.ops import _build  # noqa: E402
from parallelraytracing_tpu_torch.utils import diagnostics  # noqa: E402

SKIPPED = ["device", "nvcc", "triton"] + [f"build:{n}" for n in _build.LIBRARIES]


def test_run_diagnostics_cpu_rows():
    res = diagnostics.run_diagnostics("cpu", verbose=False)
    want = (["torch"] + SKIPPED + ["native"]
            + [f"engine:{e}" for e in T.available_engines()])
    assert list(res) == want
    for name, row in res.items():
        assert set(row) == {"ok", "detail", "ms"}, name
        assert row["ok"], (name, row)
    for name in SKIPPED:
        assert res[name]["detail"] == "skipped: cpu"
    assert res["torch"]["detail"].startswith(f"torch {torch.__version__}")
    for e in T.available_engines():
        assert res[f"engine:{e}"]["detail"] == "rendered"
        assert res[f"engine:{e}"]["ms"] is not None


def test_working_engines_cpu_lists_every_engine():
    assert diagnostics.working_engines("cpu") == T.available_engines()
    assert len(T.available_engines()) == 10


def test_cli_doctor_cpu(capsys):
    assert cli.main(["--device", "cpu", "--doctor"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + len(SKIPPED) + 1 + len(T.available_engines())
    assert sum(line.startswith("[SKIP]") for line in out) == len(SKIPPED)
    assert not any(line.startswith("[FAIL]") for line in out)


def test_cli_stats_prints_the_timer_summary(tmp_path, capsys):
    out_png = str(tmp_path / "out.png")
    assert cli.main(["--device", "cpu", "--engine", "megakernel", "--scene",
                     "material_test", "--width", "16", "--height", "8",
                     "--depth", "2", "--frames", "3", "--stats", "--out",
                     out_png]) == 0
    out = capsys.readouterr().out
    assert out.count("render ") >= 3
    assert "stage             last ms    mean ms   (n)" in out
    assert "(host time only: no CUDA device)" in out
    assert (tmp_path / "out.png").exists()
