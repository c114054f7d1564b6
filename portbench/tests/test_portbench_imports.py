"""Nothing under portbench/ imports jax, jaxlib, flax or hpfw_tpu (top-level
names compared whole) or reads benchmarks/; reference/ imports no
hpfw_tpu_torch either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hpfw_tpu", "benchmarks"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_reference_package(path):
    bad = imported(path) & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:
        bad |= imported(path) & {"hpfw_tpu_torch", "portbench"}
    assert not bad, f"{path.relative_to(HERE)} imports {sorted(bad)}"


def test_top_level_names_compared_whole():
    assert "hpfw_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.serve, portbench.reference.extract; "
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'hpfw_tpu', 'hpfw_tpu_torch'}); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_harness_refuses_jax_in_the_process(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "hpfw_tpu_torch.api", object())
    assert harness.jax_loaded() == ["jaxlib.xla_client"]
