"""Readings that the limits of ``bench/reference/check.py`` are set from.

For each seed, one process on the card makes the cell's patterns (every
lane of a batched configuration) and runs a short stretch of its traffic
through the program, and holds three sets of answers, every lane of each,
against the float32 reference by the run's own comparison:

- ``program``: the program's answers (the lower readings);
- ``control``: the plain reference put in the program's place and
  computed in bfloat16, the precision below the configuration's float32
  (the upper readings);
- ``stale``: every call answered with the program's answer to the first
  set-up call, as a step that hands back its state unchanged would.

Of a batch, each set's line also counts, by kind, the lane-calls that were
off (``<set>_off_by_kind``).

The benchmark's own runs never run this.

    python3 bench/control.py --workload uniform_1m5.cold --seeds 21 22 23

prints one JSON line per seed, with the card's name.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

if __name__ == "__main__":
    ROOT = pathlib.Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from bench import harness  # noqa: E402
from bench.gen.pattern import make_lanes  # noqa: E402
from bench.gen.traffic import Stream  # noqa: E402
from bench.reference.awpm import Reference, preflight_issues  # noqa: E402
from bench.reference.check import Served  # noqa: E402

#: calls after the warm-up that a reading covers: as many as a cold run
#: checks, and a dozen of a warm run's chain
CHECKED_CALLS = {False: harness.CHECK_COLD_CALLS, True: 12}


def control_answers(lanes, mix, window: range,
                    dtype=torch.bfloat16) -> dict[int, list[Served]]:
    """The control's answer to each lane of each call of ``window``, as the
    program's would be served: its weight summed in ``dtype``."""
    ctl = [Reference(p.row, p.col, p.n, dtype=dtype) for p in lanes]
    out = {k: [None] * len(lanes) for k in window}
    for k, b, val, ans in harness.answers(ctl, lanes, mix, set(window),
                                          window.stop):
        p = lanes[b]
        out[k][b] = Served(mate_row=ans.mate_row, mate_col=ans.mate_col,
                           rounds=ans.rounds, perfect=ans.perfect(),
                           weight=float(ans.u[:-1].sum()),
                           issues=frozenset(preflight_issues(
                               p.row, p.col, val.to(dtype), p.n)))
    return out


def readings(spec: dict, name: str, seed: int, device: torch.device,
             config: dict | None = None) -> dict:
    """The program's, the control's and the stale answer's compared
    numbers for one seed."""
    from repro_torch.core import api

    _, config, mix = harness.resolve(spec, name, config)
    lanes = make_lanes(config, seed, device)
    window = range(mix.warmup_calls,
                   mix.warmup_calls + CHECKED_CALLS[mix.warm_start])
    caller = harness.Caller(api, lanes, "batch" in config,
                            Stream(mix, lanes), device)
    served = {k: caller.call() for k in range(window.stop)}
    first = served[0]
    served = {k: served[k] for k in window}
    caller.prev = None
    out = {"seed": seed, "calls": len(window), "lanes": len(lanes)}
    for label, answers in (
            ("program", served),
            ("control", control_answers(lanes, mix, window)),
            ("stale", {k: first for k in window})):
        tally = harness.check(lanes, mix, seed, answers, window)
        out[label] = tally.numbers()
        if len(lanes) > 1:  # which kinds' lanes were off, in how many calls
            off = {}
            for b, calls in tally.lanes_off.items():
                off[lanes[b].kind] = off.get(lanes[b].kind, 0) + calls
            out[label + "_off_by_kind"] = off
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device here")
        return 2
    card = torch.cuda.get_device_name(0)
    spec = harness.load_spec()
    for seed in args.seeds:
        row = readings(spec, args.workload, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
