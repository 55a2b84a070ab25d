"""``BENCHMARK.json``: loading a cell and everything it names, and the
check of the manifest's own rules.

Each part is found by its name: a configuration's file is the one its
entry names (``configs/<name>.json``) with its reference in
``reference/<name>.py``; a mix is ``mixes/<traffic>.json``; a metric's
reader is ``metrics/<name>.py``; a cell's correctness limit is
``cells/<name>.json``.  Adding any of them adds files and entries only.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str, bench: Path = BENCH) -> dict:
    """The cell ``name`` with its configuration file (``c``, its ``name``
    and ``reference_file`` set), mix, correctness limits, metric entries and
    the directory they came from."""
    w = {x["name"]: x for x in manifest["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = {x["name"]: x for x in manifest["configs"]}[w["config"]]
    c = json.loads((bench.parent / conf["file"]).read_text())
    c["name"] = conf["name"]
    c["reference_file"] = str(bench / "reference" / f"{conf['name']}.py")
    mix = json.loads((bench / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "cells" / f"{name}.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": w, "c": c, "mix": mix, "limits": limits, "bench": bench,
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def check(manifest: dict, bench: Path = BENCH) -> list[str]:
    """Every breach of the manifest's rules (empty when there is none)."""
    bad = []
    cells = manifest["workloads"]
    configs = {c["name"]: c for c in manifest["configs"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {m["name"]: m for m in manifest["per_layer"]}
    names = [x["name"] for x in cells] + list(configs) + list(e2e) + list(layers)
    for n in names:
        if not NAME.match(n):
            bad.append(f"name {n!r} has a character outside [A-Za-z0-9_.-] or is too long")
    for group in (cells, manifest["configs"], manifest["end_to_end"] + manifest["per_layer"]):
        seen = [x["name"] for x in group]
        bad += [f"name {n!r} appears twice" for n in set(seen) if seen.count(n) > 1]
    texts = [x["why"] for x in cells + manifest["configs"]] + [m["layer"] for m in layers.values()]
    texts += [x["source"] for x in manifest["configs"]] + manifest["command"]
    bad += [f"text of {len(t)} characters or on more than one line: {t[:40]!r}"
            for t in texts if not 1 <= len(t) <= 200 or "\n" in t or "\t" in t]
    for m in list(e2e.values()) + list(layers.values()):
        if not UNIT.match(m["unit"]):
            bad.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            bad.append(f"{m['name']}: better {m['better']!r}")
        if not (bench / "metrics" / f"{m['name']}.py").exists():
            bad.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    for m in e2e.values():
        if m["source"] not in SOURCES_E2E:
            bad.append(f"{m['name']}: an end-to-end metric's source is {m['source']!r}")
        if not 0.01 <= m["bound"] <= 0.25:
            bad.append(f"{m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in layers.values():
        if m["source"] not in SOURCES:
            bad.append(f"{m['name']}: source {m['source']!r}")
        if m["moves"] not in e2e:
            bad.append(f"{m['name']}: moves {m['moves']!r}, not an end-to-end metric")
    for x in cells:
        if x["config"] not in configs:
            bad.append(f"{x['name']}: configuration {x['config']!r} is not listed")
        if not (bench / "mixes" / f"{x['traffic']}.json").exists():
            bad.append(f"{x['name']}: no mix mixes/{x['traffic']}.json")
        if not (bench / "cells" / f"{x['name']}.json").exists():
            bad.append(f"{x['name']}: no limits cells/{x['name']}.json")
        if x["chips"] not in (1, 4):
            bad.append(f"{x['name']}: chips {x['chips']}")
        reports = {m["name"] for m in e2e.values() if "workloads" not in m
                   or x["name"] in m["workloads"]}
        mine = [m for m in layers.values() if "workloads" not in m
                or x["name"] in m["workloads"]]
        if "setup_s" not in reports or len(reports) < 2 or not mine:
            bad.append(f"{x['name']}: reports too few metrics")
        bad += [f"{x['name']}: reports {m['name']} but not its {m['moves']}"
                for m in mine if m["moves"] not in reports]
    pairs = [(x["config"], x["traffic"]) for x in cells]
    bad += [f"cell {p} appears twice" for p in set(pairs) if pairs.count(p) > 1]
    if sum(x["chips"] == 4 for x in cells) > max(1, len(cells) // 4):
        bad.append("more than a quarter of the cells take 4 chips")
    for name, conf in configs.items():
        if not any(x["config"] == name for x in cells):
            bad.append(f"configuration {name!r} has no cell")
        if not (bench.parent / conf["file"]).exists():
            bad.append(f"configuration {name!r}: no file {conf['file']}")
        if not (bench / "reference" / f"{name}.py").exists():
            bad.append(f"configuration {name!r}: no reference/{name}.py")
        else:
            c = json.loads((bench.parent / conf["file"]).read_text())
            published = c.get("reduced", {})
            if sorted(published) != sorted(conf["reduced"]):
                bad.append(f"configuration {name!r}: reduced {conf['reduced']} but the file "
                           f"changes {sorted(published)}")
    for m in list(e2e.values()) + list(layers.values()):
        for w in m.get("workloads", []):
            if w not in {x["name"] for x in cells}:
                bad.append(f"{m['name']}: lists unknown cell {w!r}")
    return bad
