"""Finds everything a cell needs by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix.  The configuration is
``configs/<name>.json`` and names its codec, ``codecs/<codec>.py``, and
the generator of its blocks, ``generators/<generator>.py``; the mix is
``mixes/<traffic>.json``; each end-to-end metric is read by
``e2e/<metric>.py`` and each per-layer metric by
``metrics/<metric>.py``.  A later cell, mix, codec or metric is a new
file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent     # the benchmark's folder


def load_module(path: Path, prefix: str):
    """Import a file by its path under a name of its own (metric files
    have dots in their names, and ``codecs`` is also a standard
    module)."""
    name = f"cram_bench_{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic: str
    config: dict
    mix: dict
    codec: object
    codec_file: Path
    generator: object
    generator_file: Path
    end_to_end: list = field(default_factory=list)     # [(entry, reader)]
    per_layer: list = field(default_factory=list)      # [(entry, reader)]


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load(cell_name: str, bench_file: Path, here: Path = HERE) -> Cell:
    """The cell ``cell_name`` of ``bench_file``, its files found under
    ``here`` (the benchmark's folder)."""
    bench = json.loads(Path(bench_file).read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in work:
        raise KeyError(f"no workload {cell_name!r} in {bench_file}")
    w = work[cell_name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = cfgs[w["config"]]
    config = json.loads((here.parent / cfg_entry["file"]).read_text())
    mix = json.loads((here / "mixes" / f"{w['traffic']}.json").read_text())
    codec_file = here / "codecs" / f"{config['codec']}.py"
    generator_file = here / "generators" / f"{config['generator']}.py"
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    return Cell(
        name=cell_name, chips=int(w["chips"]), config_name=w["config"],
        traffic=w["traffic"], config=config, mix=mix,
        codec=load_module(codec_file, "codec"), codec_file=codec_file,
        generator=load_module(generator_file, "generator"),
        generator_file=generator_file,
        end_to_end=[(m, load_module(here / "e2e" / f"{m['name']}.py", "e2e"))
                    for m in e2e],
        per_layer=[(m, load_module(here / "metrics" / f"{m['name']}.py",
                                   "metric")) for m in layer])
