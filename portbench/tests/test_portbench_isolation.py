"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Names are
compared by their top-level part (before the first dot), whole: the
port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
EVERYWHERE = {"jax", "jaxlib", "flax", "tpu_docker_api"}
IN_REFERENCE = EVERYWHERE | {"tpu_docker_api_torch"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(PORTBENCH.rglob("*.py"))


def test_walks_every_module():
    assert PORTBENCH / "run.py" in MODULES
    assert any(p.parent.name == "reference" for p in MODULES)


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(PORTBENCH)) for p in MODULES])
def test_no_forbidden_import(path):
    banned = IN_REFERENCE if "reference" in path.parts else EVERYWHERE
    assert not top_level_imports(path) & banned


def test_the_check_compares_whole_names():
    src = "import tpu_docker_api_torch.models\nfrom jax import numpy\n"
    tmp = ast.parse(src)
    names = set()
    for node in ast.walk(tmp):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"tpu_docker_api_torch", "jax"}
    assert "tpu_docker_api_torch" not in EVERYWHERE
    assert names & EVERYWHERE == {"jax"}


def test_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types

    from portbench import run

    monkeypatch.setitem(sys.modules, "tpu_docker_api.models",
                        types.ModuleType("tpu_docker_api.models"))
    assert run.forbidden_modules() == ["tpu_docker_api"]
    monkeypatch.delitem(sys.modules, "tpu_docker_api.models")
    monkeypatch.setitem(sys.modules, "tpu_docker_api_torch_x",
                        types.ModuleType("tpu_docker_api_torch_x"))
    assert run.forbidden_modules() == []
