#!/usr/bin/env python3
"""Round times of the port's round variants on the card: the exact and
the fused Eq. 3 pass on the sequential driver, and the pipelined driver
in order (``overlap="none"``) and stale-by-one (``"rounds"``), plus the
per-phase split of the sequential round.

    python3 benchmarks/torch_round_variants.py [--rounds R] [--turns T]

Needs one CUDA card (exits 2 without one).  Runs ``chip_smoke.py``'s main
path configuration (mnist-cnn at full width, 20 nodes, full graph, 1
local epoch, ``TrainConfig`` defaults, the 16-bit wire, its
7040-image data) through ``run_federation`` for R rounds (default 6) a
run: one 1-round warm-up, then T turns (default 2), each running the
four variants once, in ``VARIANTS`` order on even turns and reversed on
odd ones, so that no variant always runs first.  A round's time is
``run_federation``'s own (host clock, synchronized at the round's end);
each run's first round (which pays cuDNN's algorithm search) is left
out.  ProFe's teacher trains only while ``teacher_active`` holds
(rounds 1-4 at the default ``alpha_s`` 0.7 and ``alpha_limit`` 0.05),
so a round costs about twice as much before as after: every statistic
is kept apart for the two regimes (``teacher`` and ``student``).  Then
one more exact sequential run with each phase synchronized and timed
(``chip_smoke.timed_phases``: train, Eq. 3, share, mix), apart from the
timed runs because the synchronizations cost time.  Prints each run's
round times, each variant's median and quartiles over its steady rounds
of each regime, the phase medians of each regime, the card's
``nvidia-smi`` name and power limit, and one JSON object last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name -> (FederationConfig fields, run_federation keywords)
VARIANTS = {"exact": ({}, {}),
            "fused": (dict(proto_pass="fused"), {}),
            "none": ({}, dict(overlap="none")),
            "rounds": ({}, dict(overlap="rounds"))}


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if args.rounds < 6 or args.turns < 1:
        ap.error("needs --rounds >= 6 (two steady rounds of each regime) "
                 "and --turns >= 1")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_round_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import path_inputs, timed_phases
    from repro_torch.core import federation
    from repro_torch.core.distillation import teacher_active
    from repro_torch.kernels.build import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    build()
    cfg, fed, train, node_data, test_d = path_inputs("mnist-cnn")
    fed = dataclasses.replace(fed, rounds=args.rounds)
    # each round's regime; round 1 (cuDNN's algorithm search) is in none
    regime = [None] + ["teacher" if teacher_active(
        fed.alpha_s, fed.alpha_limit, rnd) else "student"
        for rnd in range(1, args.rounds)]

    def split(xs):
        return {r: [x for x, g in zip(xs, regime) if g == r]
                for r in ("teacher", "student")}

    def run(name, rounds=args.rounds):
        fed_kw, run_kw = VARIANTS[name]
        res = federation.run_federation(
            cfg, dataclasses.replace(fed, rounds=rounds, **fed_kw), train,
            node_data, test_d, **run_kw)
        return res.extras["round_times_s"]

    run("exact", rounds=1)                                  # warm-up
    steady = {name: {"teacher": [], "student": []} for name in VARIANTS}
    runs = []
    for turn in range(args.turns):
        order = list(VARIANTS) if turn % 2 == 0 else list(VARIANTS)[::-1]
        for name in order:
            times = run(name)
            runs.append({"turn": turn, "variant": name, "round_s": times})
            for r, xs in split(times).items():
                steady[name][r] += xs
            print(f"turn {turn} {name}: round seconds {times}", flush=True)

    seconds = {}
    restore = timed_phases(torch, federation, seconds)
    try:
        run("exact")
    finally:
        restore()
    phases = {"train": [t - e for t, e in zip(seconds["train+eq3"],
                                                seconds["eq3"])],
              "eq3": seconds["eq3"], "share": seconds["share"],
              "mix": seconds["mix"]}
    phase_med = {r: {k: statistics.median(split(v)[r])
                     for k, v in phases.items()}
                 for r in ("teacher", "student")}
    print(f"phase seconds per round (synchronized, exact sequential): "
          f"{json.dumps(phases)}")
    summary = {name: {r: quartiles(xs) for r, xs in by.items()}
               for name, by in steady.items()}
    for name, by in summary.items():
        for r, q in by.items():
            print(f"{name}, {r} rounds: median {q['median']!r} s (q1 "
                  f"{q['q1']!r}, q3 {q['q3']!r}) over {q['n']} rounds")
    for r, med in phase_med.items():
        print(f"phase medians, {r} rounds: {json.dumps(med)}")
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "rounds": args.rounds, "turns": args.turns,
                      "variants": summary, "phase_median_s": phase_med,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
