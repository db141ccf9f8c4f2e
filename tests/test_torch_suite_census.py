"""``scripts/suite_census.py``, the suite's time census, on
synthetic input: per-file seconds from pytest's ``--durations=0``
lines, the compile census's repeats by scope, and the CPU counters it
reads from ``/proc/stat``.
"""
import importlib.util
from pathlib import Path

import torch

torch.set_num_threads(2)


def _census():
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "suite_census.py"
    spec = importlib.util.spec_from_file_location("suite_census", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_file_seconds_sums_setup_call_and_teardown():
    log = "\n".join([
        "============ slowest durations ============",
        "12.50s call     tests/test_torch_a.py::test_x[p-1]",
        "3.25s setup    tests/test_torch_a.py::test_x[p-1]",
        "0.25s teardown tests/test_torch_a.py::test_y",
        "7.00s call     tests/test_b.py::test_z",
        "(3 durations < 0.005s hidden.)",
        "2 passed in 23.00s",
    ])
    assert _census().file_seconds(log) == {"tests/test_torch_a.py": 16.0,
                                           "tests/test_b.py": 7.0}


def test_compile_census_counts_repeats_by_scope():
    recs = [("gw0", "a.py", "f1", 2.0), ("gw0", "a.py", "f1", 1.0),
            ("gw0", "b.py", "f1", 4.0), ("gw1", "c.py", "f1", 3.0),
            ("gw1", "c.py", "f2", 5.0)]
    got = _census().compile_census(recs)
    assert (got["compiles"], got["fingerprints"], got["seconds"]) == \
        (5, 2, 15.0)
    assert got["repeat_seconds_within_file"] == 1.0       # a.py's second
    assert got["repeat_seconds_within_worker"] == 3.0     # gw0 but its 4.0
    assert got["repeat_seconds_anywhere"] == 6.0          # f1 but its 4.0
    assert got["shared_by_files"] == [("a.py | b.py | c.py", 6.0)]


def test_cpu_jiffies_grow():
    census = _census()
    busy0, idle0 = census.cpu_jiffies()
    sum(i * i for i in range(2_000_000))
    busy1, idle1 = census.cpu_jiffies()
    assert busy1 >= busy0 and idle1 >= idle0
    assert busy1 + idle1 > busy0 + idle0
