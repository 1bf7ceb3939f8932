"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its entry in ``configs`` names and its
traffic mix is ``traffic/<traffic>.json``. Code is found by name too:

- ``metrics/<metric>.py`` reads one metric: ``read(run) -> float | None``
  and, where it needs them, ``SPANS`` (label -> ``"module:attr"``: host
  spans over the window) and ``SLICE_CALLS`` (label -> ``"module:attr"``:
  the calls made during the profiled slice, with their arguments and
  results);
- ``systems/<system>.py`` builds the system under test that the
  configuration's ``system`` names and steps it a frame at a time;
- ``sensors/<sensor>.py`` renders what the configuration's ``sensor``
  delivers a frame, and what it delivers when the view is blacked out;
- ``oracles/<oracle>.py`` reads the numbers that decide ``correct``, for
  each oracle the configuration's ``correct.oracles`` lists.

Adding a configuration, a mix, a metric, a system, a sensor or an oracle
adds files and entries; no file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    def __init__(self, doc: dict | None = None, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.doc = doc if doc is not None else json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict = {}

    @staticmethod
    def _named(entries: list, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.doc["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.doc["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
        reports: those that list it, and those without a list that move an
        end-to-end metric the workload reports."""
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py``, loaded once."""
        mod = self._modules.get((kind, name))
        if mod is None:
            path = self.dir / kind / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {path}")
            spec = importlib.util.spec_from_file_location(
                f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[(kind, name)] = mod
        return mod

    def reader(self, metric: str):
        return self.module("metrics", metric)

    def system(self, name: str):
        return self.module("systems", name)

    def sensor(self, name: str):
        return self.module("sensors", name)

    def oracle(self, name: str):
        return self.module("oracles", name)
