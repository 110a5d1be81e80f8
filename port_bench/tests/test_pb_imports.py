"""A walk of ``port_bench/``: no module imports JAX, Flax or the JAX package
(top-level names compared whole: ``a3vlm_tpu_torch`` is the port, not
``a3vlm_tpu``), and the references import nothing of the port, directly
or through another module of the benchmark."""

import ast

import pytest
from conftest import ROOT

PB = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "a3vlm_tpu"}


def imports(path):
    """Every module name a file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def module_file(name):
    parts = name.split(".")
    for cand in (ROOT.joinpath(*parts).with_suffix(".py"),
                 ROOT.joinpath(*parts, "__init__.py")):
        if cand.exists():
            return cand
    return None


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import a3vlm_tpu_torch.meta\nfrom jax import numpy\n")
    tops = {name.split(".")[0] for name in imports(f)}
    assert tops & FORBIDDEN == {"jax"}


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    seen, todo = set(), [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in imports(f):
            assert name.split(".")[0] != "a3vlm_tpu_torch", (f, name)
            if name.split(".")[0] == "port_bench":
                dep = module_file(name)
                if dep is not None:
                    todo.append(dep)
