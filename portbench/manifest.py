"""``BENCHMARK.json`` and the files it names, found by name.

Whatever belongs to one configuration, traffic mix, cell or per-layer
metric sits in a file of its own, so a new one is a new file and an entry
in ``BENCHMARK.json``, with no file edited:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  whose ``reference`` names the plain reference module beside it
  (``reference/<reference>.py``);
- a traffic mix: ``traffic/<name>.json``, data whose ``kind`` names the
  loop that runs it, ``loops/<kind>.py`` (``run`` and ``check``);
- a cell's limits of the comparison: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class Manifest:
    """The benchmark at ``root`` (the repo's root: ``BENCHMARK.json`` and
    the harness's folder ``harness``)."""

    def __init__(self, root: Path = REPO, harness: Path = HERE):
        self.root = Path(root)
        self.harness = Path(harness)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.harness / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.harness / "limits" / f"{cell}.json").read_text())

    def reference(self, config: dict):
        """The plain reference module that ``config`` names."""
        return importlib.import_module(f"{self.harness.name}.reference.{config['reference']}")

    def _metrics(self, kind: str, cell: str) -> list:
        """The ``kind`` metrics this cell reports: those that list it, and
        those that list no cells and move (or are) an end-to-end metric the
        cell reports."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in names)]

    def end_to_end(self, cell: str) -> list:
        return self._metrics("end_to_end", cell)

    def per_layer(self, cell: str) -> list:
        return self._metrics("per_layer", cell)

    def _load(self, folder: str, name: str):
        spec = importlib.util.spec_from_file_location(
            f"{self.harness.name}.{folder}.{name.replace('.', '_')}",
            self.harness / folder / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def loop(self, kind: str):
        """The module ``loops/<kind>.py`` that runs traffic of ``kind``."""
        return self._load("loops", kind)

    def reader(self, metric: str):
        """``read(ctx)`` of ``metrics/<metric>.py``."""
        return self._load("metrics", metric).read
