"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the configuration's ``file`` holds its
sizes and names its task (``portbench/tasks/<task>.py``), the traffic mix is
``portbench/traffic/<traffic>.json``, and each per-layer metric is read by ``portbench/metrics/<name>.py``.
Adding a cell, a configuration, a mix or a metric adds files and entries; no file here changes.
"""

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    def __init__(self, name: str, bench: Optional[Dict[str, Any]] = None, root: Path = ROOT) -> None:
        self.bench = bench if bench is not None else json.loads((root / "BENCHMARK.json").read_text())
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        entry = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        self.root = root
        self.traffic = json.loads((root / "portbench" / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.chips = int(self.workload["chips"])

    def task(self):
        return importlib.import_module(f"portbench.tasks.{self.config['task']}")

    def limits(self) -> Dict[str, float]:
        """The limit of each number compared: the configuration's, then the mix's, which take precedence."""
        return {**self.config.get("limits", {}), **self.traffic.get("limits", {})}

    def _listed(self, metric: Dict[str, Any]) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.bench["end_to_end"] if self._listed(m)]

    def per_layer(self) -> List[Dict[str, Any]]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._listed(m) and ("workloads" in m or m["moves"] in reported)]

    def reader(self, name: str) -> Callable:
        """The ``read`` function of ``portbench/metrics/<name>.py`` (names hold dots, so it loads by path)."""
        path = self.root / "portbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def peaks() -> Dict[str, float]:
    return json.loads((HERE / "peaks.json").read_text())
