"""Finds a cell's parts by the names `BENCHMARK.json` gives them.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel family is a file of its own under `bench/`, found by
name, so a later change adds a cell by adding files:

  configuration     the `file` its entry in `configs` names (JSON)
  traffic mix       bench/traffic/<traffic>.json, whose `loop` names
                    bench/traffic/loops/<loop>.py (the code that drives
                    the window; bench/harness/client.py says what it
                    defines)
  per-layer metric  bench/metrics/<metric>.py, defining read(ctx); a
                    metric split by the end-to-end metric it moves in
                    different cells (`<quantity>.<part>`) may share the
                    reader of its quantity, bench/metrics/<quantity>.py
  kernel family     bench/roofline/<family>.py (its operations and bytes)
                    and bench/roofline/names/<family>/*.json (the device
                    kernels the count is held against; every file adds
                    names)
  device peaks      bench/roofline/peaks.json, by the device's name
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]


class Registry:
    """The benchmark rooted at `root` (a checkout holding BENCHMARK.json
    and bench/)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        with open(path) as f:
            self.spec = json.load(f)
        self._modules: dict = {}

    @property
    def bench(self) -> Path:
        return self.root / "bench"

    def _named(self, kind: str, name: str) -> dict:
        for entry in self.spec[kind]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {kind[:-1]} named {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._named("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.bench / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def loops(self) -> List[str]:
        """The names of the traffic loops the benchmark has."""
        return sorted(p.stem for p in
                      (self.bench / "traffic" / "loops").glob("*.py"))

    def loop(self, name: str):
        """The module of traffic loop `name`."""
        return self.module(self.bench / "traffic" / "loops" / f"{name}.py")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those listing no cells whose end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def module(self, path: Path):
        """The Python file at `path`, loaded once."""
        path = Path(path)
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                "bench_file_" + "_".join(path.relative_to(self.root).parts)
                .replace(".", "_").replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def metric_reader(self, name: str):
        """`read` of bench/metrics/<name>.py or, where there is none, of
        the file of the longest leading part of `name` that has one
        (`service.assembly_ms.host` is read by service.assembly_ms.py)."""
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            path = self.bench / "metrics" / (".".join(parts[:n]) + ".py")
            if path.is_file():
                return self.module(path).read
        raise FileNotFoundError(f"no reader in bench/metrics for {name!r}")

    def kernel_count(self, family: str):
        return self.module(self.bench / "roofline" / f"{family}.py")

    def kernel_names(self, family: str) -> List[str]:
        names: List[str] = []
        for path in sorted((self.bench / "roofline" / "names" / family)
                           .glob("*.json")):
            with open(path) as f:
                names.extend(json.load(f)["kernels"])
        return names

    def peaks(self, device_kind: str) -> Optional[dict]:
        with open(self.bench / "roofline" / "peaks.json") as f:
            return json.load(f)["devices"].get(device_kind)
