"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

A configuration is ``configs/<config>.json`` (its ``file``), a traffic mix
``traffic/<traffic>.json``, a cell's limits ``limits/<workload>.json``, a
metric ``metrics/<metric>.py`` (a ``read(run)`` that returns a number or
None), a family's seam and program side, plain reference and counts
``families/<family>.py``, ``reference/<family>.py`` and
``counts/<counts>.py``, and the client that drives the program
``drivers/<driver>.py``, where the mix's ``driver`` names it
(``lockstep`` where it names none). A mix holds the family's fields and
its driver's. Adding any of them is adding a file and an entry: no file
here names them."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

__all__ = ["Cell", "load_bench", "load_cell", "load_module", "HERE"]

HERE = Path(__file__).resolve().parent
_SAFE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not _SAFE.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_bench(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(folder: Path, kind: str, name: str) -> ModuleType:
    """``<folder>/<kind>/<name>.py`` as a module of its own, entered in
    ``sys.modules`` while it runs (a dataclass in it looks its module up
    there)."""
    path = Path(folder) / kind / f"{_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"portbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    cfg: dict            # the configuration as run
    traffic: Any         # the mix as the family reads it
    limits: dict         # number compared -> its limit
    family: ModuleType
    reference: ModuleType
    counts: ModuleType
    metrics: dict        # metric name -> (entry, reader module)
    per_layer: dict      # the same for the per-layer metrics
    driver: ModuleType   # drivers/<driver>.py: the client of the window
    mix: dict            # the traffic file as written (the driver's fields)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark whose ``BENCHMARK.json`` is
    at ``root``; its files are read from ``root/portbench``."""
    root = Path(root)
    folder = root / HERE.name
    bench = load_bench(root)
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    confs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(confs) != 1:
        raise KeyError(f"no config {entry['config']!r} in BENCHMARK.json")
    cfg = json.loads((root / confs[0]["file"]).read_text())
    mix = json.loads(
        (folder / "traffic" / f"{_name(entry['traffic'])}.json").read_text())
    fam = _name(cfg["family"])
    family = load_module(folder, "families", fam)
    driver = load_module(folder, "drivers", mix.get("driver", "lockstep"))
    unknown = set(mix) - set(family.FIELDS) - {"driver", *driver.FIELDS}
    if unknown:
        raise ValueError(f"traffic {entry['traffic']!r}: fields "
                         f"{sorted(unknown)} are not its family's or its "
                         "driver's")
    limits = json.loads(
        (folder / "limits" / f"{_name(workload)}.json").read_text())

    def readers(kind):
        return {m["name"]: (m, load_module(folder, "metrics", m["name"]))
                for m in bench[kind] if _applies(m, workload)}

    return Cell(
        name=workload, entry=entry, cfg=cfg, traffic=family.traffic(mix),
        limits=limits, family=family,
        reference=load_module(folder, "reference", fam),
        counts=load_module(folder, "counts", cfg["counts"]),
        metrics=readers("end_to_end"), per_layer=readers("per_layer"),
        driver=driver, mix=mix,
    )
