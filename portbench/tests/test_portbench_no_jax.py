"""Nothing the benchmark runs loads JAX or the JAX package, and the reference loads nothing of the port.

Module names are compared by their top-level name (the part before the first dot), whole: the port's own
name, ``metrics_tpu_torch``, begins with the JAX package's, so a prefix match would be wrong."""

import ast
import json
import subprocess
import sys

from portbench.cell import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "metrics_tpu"]

SCRIPT = r"""
import importlib, importlib.util, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
import portbench
for path in sorted((root / "portbench").rglob("*.py")):
    rel = path.relative_to(root)
    if rel.parts[1] == "tests":
        continue
    if rel.parts[1] == "metrics":
        spec = importlib.util.spec_from_file_location("pb_metric_" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts).removesuffix(".__init__"))
if sys.argv[2] == "port":
    import metrics_tpu_torch as mt
    mt.FrechetInceptionDistance, mt.MetricCollection, mt.JaccardIndex, mt.Accuracy, mt.ConfusionMatrix
    import metrics_tpu_torch.image.backbones.inception, metrics_tpu_torch.image.backbones.convert
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""


def _top_level_names(mode):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT), mode], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_benchmark_and_the_port_it_drives_load_neither_jax_nor_the_jax_package():
    names = _top_level_names("port")
    assert "metrics_tpu_torch" in names and "portbench" in names
    assert not names & set(FORBIDDEN)


def test_the_check_compares_whole_top_level_names():
    from portbench.run import forbidden_modules

    assert "metrics_tpu_torch".split(".")[0] not in FORBIDDEN
    assert not set(forbidden_modules()) - set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((ROOT / "portbench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & {"metrics_tpu_torch", *FORBIDDEN}, (path.name, tops)
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, json; sys.path.insert(0, sys.argv[1]);"
                           "import portbench.reference.segmentation, portbench.reference.inception, "
                           "portbench.reference.fid;"
                           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))", str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not names & {"metrics_tpu_torch", *FORBIDDEN}
