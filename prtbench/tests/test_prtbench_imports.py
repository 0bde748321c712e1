"""Nothing the benchmark runs imports JAX, the JAX package, or the JAX
package's old benchmarks and records."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from prtbench import cell, run

BASE = run.ROOT / "prtbench"
#: the JAX package's benchmark files the harness may not read, named in
#: pieces so that this file does not hold them whole
OLD = ("bench" + ".py", "bench" + "marks", "BENCH" + "_", "BASE" + "LINE")


def _modules():
    return sorted(p for p in BASE.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in _modules():
        bad = _top_level_imports(path) & set(cell.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_renderer_is_not_taken_for_the_jax_package():
    # names are compared whole: the port's name begins with the JAX one's
    assert "parallelraytracing_tpu_torch".split(".")[0] not in cell.FORBIDDEN


def test_no_module_reads_the_old_benchmarks():
    for path in _modules():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not [w for w in OLD if w in text], path


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(run.ROOT).with_suffix("").parts)
            for p in _modules() if p.name != "__init__.py"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "from prtbench import cell\n"
            "print(cell.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(run.ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
