"""A cell as data: its entry in ``BENCHMARK.json``, its configuration file
(``configs/<config>.json``), the model family that the file names
(``families/<family>.py``), its traffic mix (``traffic/<traffic>.json``),
its limits (``limits/<workload>.json``) and the readers of its per-layer
metrics (``metrics/<metric>.py``), all found by name."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
# the family of a configuration file that names none
DEFAULT_FAMILY = "uni3detr"


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def families(bench_dir: str = HERE) -> list:
    """The names of the model families under ``families/``."""
    files = os.listdir(os.path.join(bench_dir, "families"))
    return sorted(f[:-3] for f in files
                  if f.endswith(".py") and not f.startswith("_"))


def family(name: str, bench_dir: str = HERE):
    """The model family ``families/<name>.py`` (its interface:
    ``families/__init__.py``)."""
    known = families(bench_dir)
    if name not in known:
        raise SystemExit(f"unknown family {name!r}; the families are "
                         f"{known}")
    return _module(os.path.join(bench_dir, "families", f"{name}.py"),
                   f"bench_family_{name}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix
    limits: dict          # number -> limit
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list
    bench_dir: str        # the benchmark's files
    family: object        # the configuration's model family, a module

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reader(self, metric: str):
        return _module(os.path.join(self.bench_dir, "metrics",
                                    f"{metric}.py"),
                       f"bench_metric_{metric.replace('.', '_')}").read


def _listed(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def load(root: str, workload: str, bench_dir: str = HERE) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def read(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    config = read(root, cfg_entry["file"])
    fam = family(config.get("family", DEFAULT_FAMILY), bench_dir)
    traffic = read(bench_dir, "traffic", f"{w['traffic']}.json")
    lim_path = os.path.join(bench_dir, "limits", f"{workload}.json")
    limits = read(lim_path) if os.path.exists(lim_path) else {}
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload)]
    per = [m for m in bench["per_layer"] if _listed(m, workload)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per, bench_dir, fam)
