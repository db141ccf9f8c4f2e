#!/usr/bin/env python3
"""Where the test suite's time goes: one pytest run with every test's
duration, the machine's busy and idle CPU over the run, and, with
``--compiles``, every XLA compile by HLO fingerprint and test file.

    python3 scripts/suite_census.py [--compiles] [--log FILE] [--top N]
                                    -- <pytest arguments>

Runs ``python -m pytest <arguments> --durations=0`` from the
repository's root with ``src`` on ``PYTHONPATH`` (give it the suite's
usual arguments, e.g. ``-q -p xdist -n 6 --dist loadfile -p
no:randomly``, and ``JAX_PLATFORMS=cpu`` in the environment), writes
pytest's output to ``--log``, and prints:

* the wall seconds, and the CPU's busy (user, nice, system) and idle
  core-seconds from ``/proc/stat`` before and after: the whole
  machine's, so run it alone;
* each test file's seconds (setup, call and teardown summed; a worker's
  wall time, which contention on the cores inflates), the port's files
  (``tests/test_torch_*``) and the rest totalled;
* with ``--compiles`` (this file is then loaded as a pytest plugin in
  every worker, and writes one JSON a worker beside the log): the
  compiles, their distinct HLO fingerprints and seconds, the seconds
  spent compiling a fingerprint again within one file, within one
  worker and anywhere in the run, and the groups of files that compile
  the same programs the longest;

and one JSON object last.  It measures the test suite on the CPU, the
JAX package's references included, so it is no part of the port: the
compile hook imports JAX and wraps its private
``jax._src.compiler.backend_compile_and_load`` (JAX 0.9).
"""
from __future__ import annotations

import argparse
import collections
import glob
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
CENSUS_DIR = "TORCH_SUITE_CENSUS_DIR"   # where the plugin writes its JSON
_DURATION = re.compile(r"^([\d.]+)s (setup|call|teardown)\s+([^:\s]+)")


def file_seconds(log: str) -> Dict[str, float]:
    """Each test file's seconds from pytest's ``--durations=0`` lines:
    setup, call and teardown of its tests summed."""
    out: Dict[str, float] = collections.Counter()
    for line in log.splitlines():
        m = _DURATION.match(line.strip())
        if m:
            out[m.group(3)] += float(m.group(1))
    return dict(out)


def cpu_jiffies() -> Tuple[int, int]:
    """The machine's (busy, idle) clock ticks so far: user + nice +
    system, and idle, from the first line of ``/proc/stat``."""
    with open("/proc/stat") as f:
        user, nice, system, idle = (int(x) for x in f.readline().split()[1:5])
    return user + nice + system, idle


def compile_census(records: Iterable[Tuple[str, str, str, float]],
                   top: int = 10) -> dict:
    """Compile totals over ``(worker, file, fingerprint, seconds)``
    records: a compile repeats where its fingerprint was compiled
    before in the same scope, and a scope's repeats cost all its
    compiles of the fingerprint but the longest."""
    by_fp: Dict[str, List[Tuple[str, str, float]]] = \
        collections.defaultdict(list)
    for worker, file, fp, sec in records:
        by_fp[fp].append((worker, file, sec))

    def repeats(scope: int) -> float:
        total = 0.0
        for comps in by_fp.values():
            groups: Dict[str, List[float]] = collections.defaultdict(list)
            for c in comps:
                groups[c[scope] if scope >= 0 else ""].append(c[2])
            total += sum(sum(g) - max(g) for g in groups.values())
        return total

    shared: Dict[str, float] = collections.Counter()
    for comps in by_fp.values():
        files = sorted({c[1] for c in comps})
        if len(files) > 1:
            secs = [c[2] for c in comps]
            shared[" | ".join(files)] += sum(secs) - max(secs)
    return dict(
        compiles=sum(len(c) for c in by_fp.values()),
        fingerprints=len(by_fp),
        seconds=sum(c[2] for comps in by_fp.values() for c in comps),
        repeat_seconds_within_file=repeats(1),
        repeat_seconds_within_worker=repeats(0),
        repeat_seconds_anywhere=repeats(-1),
        shared_by_files=sorted(shared.items(), key=lambda kv: -kv[1])[:top])


# -- the pytest plugin (--compiles) -------------------------------------------
_records: List[Tuple[str, str, str, float]] = []
_current = ["<collection>"]


def pytest_configure(config):
    if not os.environ.get(CENSUS_DIR):
        return
    from jax._src import compiler
    inner = compiler.backend_compile_and_load

    def timed(backend, module, *args, **kwargs):
        text = module.operation.get_asm(enable_debug_info=False)
        fp = hashlib.sha1(text.encode()).hexdigest()[:16]
        t0 = time.perf_counter()
        out = inner(backend, module, *args, **kwargs)
        _records.append((os.environ.get("PYTEST_XDIST_WORKER", "main"),
                         _current[0], fp, time.perf_counter() - t0))
        return out
    compiler.backend_compile_and_load = timed


def pytest_runtest_setup(item):
    _current[0] = item.nodeid.split("::", 1)[0]


def pytest_unconfigure(config):
    where = os.environ.get(CENSUS_DIR)
    if where and _records:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        Path(where, f"compiles-{worker}.json").write_text(
            json.dumps(_records))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compiles", action="store_true")
    ap.add_argument("--log", default=str(ROOT / "build" / "census" /
                                         "pytest.log"))
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("pytest_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    pytest_args = [a for a in args.pytest_args if a != "--"]
    log = Path(args.log)
    log.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "scripts")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "pytest", *pytest_args, "--durations=0"]
    if args.compiles:
        for old in glob.glob(str(log.parent / "compiles-*.json")):
            os.remove(old)
        env[CENSUS_DIR] = str(log.parent)
        cmd += ["-p", "suite_census"]
    busy0, idle0 = cpu_jiffies()
    t0 = time.monotonic()
    with open(log, "w") as out:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=out,
                            stderr=subprocess.STDOUT).returncode
    wall = time.monotonic() - t0
    busy1, idle1 = cpu_jiffies()
    hz = os.sysconf("SC_CLK_TCK")
    files = file_seconds(log.read_text(errors="replace"))
    port = {f: s for f, s in files.items() if "/test_torch_" in f}
    report = dict(pytest_rc=rc, wall_s=wall,
                  cpu_busy_core_s=(busy1 - busy0) / hz,
                  cpu_idle_core_s=(idle1 - idle0) / hz,
                  port_file_s=sum(port.values()),
                  other_file_s=sum(files.values()) - sum(port.values()),
                  files=dict(sorted(files.items(), key=lambda kv: -kv[1])))
    print(f"pytest rc {rc}, {wall:.0f} s wall; CPU busy "
          f"{report['cpu_busy_core_s']:.0f} core-s, idle "
          f"{report['cpu_idle_core_s']:.0f}; the port's files "
          f"{report['port_file_s']:.1f} s, the others "
          f"{report['other_file_s']:.1f} s")
    for f, s in list(report["files"].items())[:args.top]:
        print(f"{s:9.1f}  {f}")
    if args.compiles:
        records = [tuple(r) for path in sorted(
            glob.glob(str(log.parent / "compiles-*.json")))
            for r in json.loads(Path(path).read_text())]
        report["compiles"] = compile_census(records, args.top)
        print({k: v for k, v in report["compiles"].items()
               if k != "shared_by_files"})
        for files_, s in report["compiles"]["shared_by_files"]:
            print(f"{s:9.1f}  {files_}")
    print(json.dumps(report))
    return rc


if __name__ == "__main__":
    sys.exit(main())
