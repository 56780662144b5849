"""The port's public surface covers the JAX package's, module by module.

For every ``metrics_tpu/**/*.py`` the walk reads the source with ``ast``
(it imports no JAX) and requires of the port's module at the same relative
path under ``metrics_tpu_torch/``:

* that it exists;
* every public top-level function and class of the JAX module (those under
  a module-level ``if`` or ``try`` too), and every public method of those
  classes (``hasattr``: inherited methods count);
* every ``__all__`` entry of the JAX module in the port's ``__all__``, with
  the entries that ``+=``, ``.append`` and ``.extend`` add; an edit of
  ``__all__`` that the walk cannot read as a literal fails the gate.

``JAX_ONLY`` pins the names that have no counterpart on purpose, each with its
reason; a pinned name that the port gains, or that the JAX package loses,
fails the gate too.  The gate checks itself on synthetic JAX sources that
name what the port lacks.
"""

import ast
import importlib
from pathlib import Path
from typing import List, Optional

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "metrics_tpu"
PORT_ROOT = ROOT / "metrics_tpu_torch"

#: names of the JAX package with no port on purpose: ``module`` (the whole
#: module) or ``module::name`` (``__all__:name`` for an ``__all__`` entry)
JAX_ONLY = {
    "ops/stat_scores_pallas.py": "the Pallas kernel's module: its port is ops/stat_scores.py with ops/csrc/stat_scores.cu",
    "ops/stat_scores_pallas.py::pallas_available": "probes Pallas dispatch on the TPU; the port has no Pallas",
    "ops/stat_scores_pallas.py::stat_scores_fast_path_ok": "probes the Pallas kernel's fast path on the TPU",
    "ops/__init__.py::__all__:pallas_available": "re-exports the Pallas probe above",
    "image/backbones/inception.py::FlaxInceptionV3": "the Flax module; the port's network is InceptionV3",
    "image/backbones/inception.py::fast_inception_apply": "a jitted Flax apply; the port's is FoldedInceptionV3",
    "image/backbones/inception.py::fold_inception_variables": "folds the Flax variables for fast_inception_apply; "
                                                             "FoldedInceptionV3 folds its own",
    "image/backbones/__init__.py::__all__:FlaxInceptionV3": "re-exports the Flax module above",
}


def _port_module_name(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("metrics_tpu_torch",) + parts)


def _module_level(body):
    """The statements that run at import, those under a module-level ``if`` or ``try`` too."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _module_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _module_level(node.body + [s for h in node.handlers for s in h.body] + node.orelse + node.finalbody)


def _is_all(node) -> bool:
    return isinstance(node, ast.Name) and node.id == "__all__"


def _literal_all(tree: ast.Module) -> Optional[List[str]]:
    """The module's ``__all__`` from its assignments, ``+=``, ``.append`` and ``.extend``; any other
    edit of ``__all__``, or one whose value is not a literal, raises ``ValueError``."""
    names = None
    for node in _module_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.If, ast.Try)):
            continue
        if not any(_is_all(n) for n in ast.walk(node)):
            continue
        call = node.value if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) else None
        try:
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None \
                    and all(_is_all(t) for t in (node.targets if isinstance(node, ast.Assign) else [node.target])):
                names = list(ast.literal_eval(node.value))
                continue
            if isinstance(node, ast.AugAssign) and _is_all(node.target) and isinstance(node.op, ast.Add) \
                    and names is not None:
                names += list(ast.literal_eval(node.value))
                continue
            if call is not None and isinstance(call.func, ast.Attribute) and _is_all(call.func.value) \
                    and call.func.attr in ("append", "extend") and len(call.args) == 1 and not call.keywords \
                    and names is not None:
                value = ast.literal_eval(call.args[0])
                names += [value] if call.func.attr == "append" else list(value)
                continue
        except ValueError:
            pass
        raise ValueError(f"line {node.lineno}: an edit of __all__ that the gate cannot read")
    return names


def surface_gaps(rel: str, source: str, port_root: Path = PORT_ROOT) -> List[str]:
    """What the port lacks of the JAX module ``rel`` (relative to ``metrics_tpu/``) whose source is
    ``source``: ``rel`` for a missing module, ``rel::name``, ``rel::Class.method`` or ``rel::__all__:name``."""
    if not (port_root / rel).is_file():
        return [rel]
    port = importlib.import_module(_port_module_name(rel))
    tree = ast.parse(source, filename=rel)
    gaps = []
    for node in _module_level(tree.body):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) or node.name.startswith("_"):
            continue
        if not hasattr(port, node.name):
            gaps.append(f"{rel}::{node.name}")
            continue
        if isinstance(node, ast.ClassDef):
            ours = getattr(port, node.name)
            gaps += [f"{rel}::{node.name}.{sub.name}" for sub in node.body
                     if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and not sub.name.startswith("_") and not hasattr(ours, sub.name)]
    port_all = set(getattr(port, "__all__", ()))
    gaps += [f"{rel}::__all__:{name}" for name in _literal_all(tree) or () if name not in port_all]
    return gaps


JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix() for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_the_port_covers_the_jax_module(rel):
    gaps = surface_gaps(rel, (JAX_ROOT / rel).read_text(encoding="utf-8"))
    pinned = sorted(key for key in JAX_ONLY if key == rel or key.startswith(rel + "::"))
    if rel in JAX_ONLY:
        assert gaps == [rel], "a JAX-only module that the port now has: unpin it"
        return
    assert sorted(gaps) == pinned, f"names the port lacks: {sorted(set(gaps) - set(pinned))}; " \
                                   f"pinned names it has: {sorted(set(pinned) - set(gaps))}"


def test_every_pinned_name_is_the_jax_packages():
    for key in JAX_ONLY:
        rel, _, name = key.partition("::")
        source = (JAX_ROOT / rel).read_text(encoding="utf-8")
        tree = ast.parse(source)
        if not name:
            continue
        if name.startswith("__all__:"):
            assert name.split(":", 1)[1] in _literal_all(tree), key
        else:
            assert name in {n.name for n in _module_level(tree.body) if isinstance(n, (ast.FunctionDef, ast.ClassDef))}, key
    assert len(JAX_MODULES) > 200 and "utils/data.py" in JAX_MODULES


def test_the_walk_imports_no_jax():
    import subprocess
    import sys

    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import test_torch_surface as s\n"
        "assert s.surface_gaps('utils/data.py', open(s.JAX_ROOT / 'utils/data.py').read()) == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


SYNTHETIC = '''
__all__ = ["dim_zero_cat", "not_exported_by_the_port"]
__all__.append("appended_name")
__all__ += ["augmented_name"]
__all__.extend(("extended_name",))


def dim_zero_cat(x):
    return x


def not_in_the_port(x):
    return x


def _private(x):
    return x


class EnumStr:
    def from_str(self, value):
        return value

    def not_a_port_method(self):
        return None

    def _private_method(self):
        return None


class NotAPortClass:
    pass


if True:
    def defined_under_if(x):
        return x
else:
    class DefinedUnderElse:
        pass

try:
    class DefinedUnderTry:
        pass
except ImportError:
    def defined_under_except(x):
        return x
'''

SYNTHETIC_GAPS = [
    "EnumStr.not_a_port_method",
    "NotAPortClass",
    "DefinedUnderElse",
    "DefinedUnderTry",
    "__all__:appended_name",
    "__all__:augmented_name",
    "__all__:dim_zero_cat",
    "__all__:extended_name",
    "__all__:not_exported_by_the_port",
    "defined_under_except",
    "defined_under_if",
    "not_in_the_port",
]


def test_the_gate_fails_on_names_the_port_lacks():
    gaps = surface_gaps("utils/enums.py", SYNTHETIC)
    assert sorted(gaps) == sorted(f"utils/enums.py::{name}" for name in SYNTHETIC_GAPS + ["dim_zero_cat"])
    assert surface_gaps("utils/not_a_port_module.py", SYNTHETIC) == ["utils/not_a_port_module.py"]
    # the same source against a module that has those names leaves only what it lacks
    assert sorted(surface_gaps("utils/data.py", SYNTHETIC)) == sorted(
        f"utils/data.py::{name}" for name in ["EnumStr"] + SYNTHETIC_GAPS if not name.startswith("EnumStr."))


@pytest.mark.parametrize("edit", [
    "__all__ += other.__all__",
    "__all__.append(name)",
    "__all__.remove('a')",
    "__all__.insert(0, 'b')",
    "__all__ = __all__ + ['b']",
    "if True:\n    __all__.extend(names)",
])
def test_the_gate_refuses_an_all_edit_it_cannot_read(edit):
    with pytest.raises(ValueError, match="edit of __all__"):
        surface_gaps("utils/data.py", f"__all__ = ['a']\n{edit}\n")
