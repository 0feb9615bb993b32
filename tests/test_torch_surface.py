"""The port's public surface against the JAX package's, read from the
sources with `ast` (neither package is imported): every public top-level
function, class and assigned name of each `spasm_tpu` module, every
public method of its public classes, and every name a package's
`__init__.py` binds by a relative import, has a same-named counterpart
in the matching module of `spasm_tpu_torch`; the ten tools take the same
flags.  The exceptions sit in one table, each with its reason and its
counterpart, and each must still be needed."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "spasm_tpu"
PORT = ROOT / "spasm_tpu_torch"

# (module, name or "*" for the whole module) -> (reason, counterpart)
EXCEPTIONS = {
    ("__init__.py", "warm_device_async"): (
        "do not port: warms the TPU's compile cache in a thread", None),
    ("device_csr.py", "DeviceCSR.combine"): (
        "do not port: no caller in either package, tests or bench.py",
        None),
    ("dense/reduced.py", "ReducedBasis.hbm_bytes"): (
        "do not port: no caller in either package, tests or bench.py",
        None),
    ("native/__init__.py", "HAVE_NATIVE"): (
        "the port builds the host library at first use, not at import",
        ("native/__init__.py", "available")),
    ("dense/subst_pallas.py", "*"): (
        "kernel B1: the Pallas module becomes the CUDA kernel's wrapper "
        "(csrc/subst.cu)", ("dense/subst.py", "subst_waves")),
    ("dense/sweep_pallas.py", "*"): (
        "kernel B4: the Pallas module becomes the CUDA kernel's wrapper "
        "(csrc/panel.cu)", ("dense/panel.py", "panel_pivots")),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def surface(path: pathlib.Path) -> set:
    """The public names a module defines, assigns or (in a package's
    __init__.py) imports from the package, with "Class.method" for the
    public methods of its public classes."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{f.name}" for f in node.body
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and _public(f.name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out |= {t.id for t in targets
                    if isinstance(t, ast.Name) and _public(t.id)}
        elif (isinstance(node, ast.ImportFrom) and node.level > 0
              and path.name == "__init__.py"):
            out |= {a.asname or a.name for a in node.names
                    if _public(a.asname or a.name)}
    return out


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_counterpart(module):
    if (module, "*") in EXCEPTIONS:
        _, (twin, name) = EXCEPTIONS[module, "*"]
        assert not (PORT / module).exists()
        assert name in surface(PORT / twin)
        return
    assert (PORT / module).exists(), f"spasm_tpu_torch/{module} is missing"
    missing = {n for n in surface(JAX_PKG / module) - surface(PORT / module)
               if (module, n) not in EXCEPTIONS}
    assert not missing, f"spasm_tpu_torch/{module} lacks {sorted(missing)}"


@pytest.mark.parametrize("module,name", sorted(EXCEPTIONS))
def test_exception_is_still_needed(module, name):
    """Each exception names something the JAX package has and the port
    lacks, with a reason, and a counterpart where it names one."""
    reason, twin = EXCEPTIONS[module, name]
    assert reason
    if name == "*":
        assert (JAX_PKG / module).exists()
        assert not (PORT / module).exists()
    else:
        assert name in surface(JAX_PKG / module)
        assert name not in surface(PORT / module)
    if twin is not None:
        assert twin[1] in surface(PORT / twin[0])


def _flags(path: pathlib.Path) -> list:
    """The option strings of every add_argument call in a module."""
    return sorted(a.value for node in ast.walk(ast.parse(path.read_text()))
                  if isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "add_argument"
                  for a in node.args if isinstance(a, ast.Constant))


# the ten tools and common.py, which adds the flags they share
TOOLS = sorted(p.name for p in (JAX_PKG / "cli").glob("*.py")
               if p.name != "__init__.py")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_takes_the_same_flags(tool):
    assert _flags(PORT / "cli" / tool) == _flags(JAX_PKG / "cli" / tool)
