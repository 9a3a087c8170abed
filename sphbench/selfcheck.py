#!/usr/bin/env python3
"""CPU self-check of the benchmark's files and of its result line.

    python3 sphbench/selfcheck.py [--n 4096] [--quick]

1. Every workload, configuration, traffic and metric file is found by
   name, and `BENCHMARK.json` at the root names exactly those: its
   `configs` the configuration files, its `workloads` the workload files
   (name, config, traffic, chips, why), its `per_layer` the readers under
   `metrics/` (unit, better, source, layer, moves, workloads).
2. Unless `--quick`: each cell runs at n particles (its configuration's
   rehearsal form) on the CPU with the kernels' plain versions, once with
   `--trace 0` and once with `--trace 1`, and the last line of its
   standard output has exactly the contract's keys, `device` its keys,
   and with `--trace 0` every end-to-end metric of the cell.

Exits 1 and names what is wrong; prints "selfcheck ok" otherwise.
"""

import argparse
import contextlib
import importlib
import io
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
OPTIONAL_KEYS = {"breakdown", "checks"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def names(kind: str) -> set:
    return {p.stem for p in (HERE / kind).glob("[!_]*.json")}


def check_files(problems: list) -> dict:
    """Step 1; returns BENCHMARK.json."""
    from sphbench import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    confs = {c["name"]: c for c in bench["configs"]}
    if set(confs) != names("configs"):
        problems.append(f"BENCHMARK.json configs {sorted(confs)} != "
                        f"configs/ {sorted(names('configs'))}")
    for name, c in confs.items():
        conf = run.load("configs", name)
        if c["file"] != f"sphbench/configs/{name}.json":
            problems.append(f"config {name}: file {c['file']}")
        for key in ("source", "reduced"):
            if c[key] != conf[key]:
                problems.append(f"config {name}: {key} differs from its file")
    wls = {w["name"]: w for w in bench["workloads"]}
    if set(wls) != names("workloads"):
        problems.append(f"BENCHMARK.json workloads {sorted(wls)} != "
                        f"workloads/ {sorted(names('workloads'))}")
    for name, w in wls.items():
        wl, _, _ = run.cell(name)    # its configuration and traffic exist
        for key in ("config", "traffic", "chips", "why"):
            if w[key] != wl[key]:
                problems.append(f"workload {name}: {key} differs from its "
                                f"file")
    mods = {p.stem: importlib.import_module(f"sphbench.metrics.{p.stem}")
            for p in (HERE / "metrics").glob("[!_]*.py")}
    layer = {m["name"]: m for m in bench["per_layer"]}
    if set(layer) != set(mods):
        problems.append(f"BENCHMARK.json per_layer {sorted(layer)} != "
                        f"metrics/ {sorted(mods)}")
    for name, m in layer.items():
        mod = mods.get(name)
        if mod is None:
            continue
        for key, attr in (("unit", "UNIT"), ("better", "BETTER"),
                          ("source", "SOURCE"), ("layer", "LAYER"),
                          ("moves", "MOVES"), ("workloads", "WORKLOADS")):
            if m.get(key) != getattr(mod, attr):
                problems.append(f"metric {name}: {key} differs from "
                                f"metrics/{name}.py")
        if mod.NAME != name:
            problems.append(f"metrics/{name}.py: NAME {mod.NAME}")
    for name in names("traffic"):
        run.load("traffic", name)
    return bench


def check_runs(bench: dict, n: int, problems: list):
    """Step 2."""
    from sphbench import run

    e2e = bench["end_to_end"]
    for wl in bench["workloads"]:
        for trace in (0, 1):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = run.main(["--workload", wl["name"], "--seed",
                               "2147483659", "--seconds", "1", "--trace",
                               str(trace)], device="cpu", n=n)
            last = out.getvalue().strip().splitlines()[-1]
            tag = f"{wl['name']} --trace {trace}"
            if rc != 0:
                problems.append(f"{tag}: exit code {rc}")
                continue
            res = json.loads(last)
            keys = set(res)
            if not RESULT_KEYS <= keys or keys - RESULT_KEYS - OPTIONAL_KEYS:
                problems.append(f"{tag}: keys {sorted(keys)}")
            if set(res["device"]) - {"busy_s", "window_s"} != DEVICE_KEYS:
                problems.append(f"{tag}: device keys {sorted(res['device'])}")
            if list(res)[-1] != "checks":
                problems.append(f"{tag}: 'checks' is not the last key")
            want = {m["name"] for m in e2e
                    if wl["name"] in m.get("workloads", [wl["name"]])}
            if trace == 0 and set(res["metrics"]) != want:
                problems.append(f"{tag}: metrics {sorted(res['metrics'])}")
            if not res["correct"]:
                problems.append(f"{tag}: correct is false: {res['checks']}")
            print(f"{tag}: {last[:200]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    problems = []
    bench = check_files(problems)
    if not args.quick:
        check_runs(bench, args.n, problems)
    for p in problems:
        print(f"selfcheck: {p}", file=sys.stderr)
    if problems:
        return 1
    print("selfcheck ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
