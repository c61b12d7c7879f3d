"""Readings that the limits of ``bench/reference/check.py`` are set from.

For each seed, one process on the card makes the cell's patterns (every
lane of a batched configuration) and runs a short stretch of its traffic
through the program, and holds three sets of answers, every lane of each,
against the float32 reference by the run's own check (the calls it picks,
a warm call judged from the answer that seeded it):

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
import itertools
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

#: window calls that a reading covers: a cold run's checked calls, and a
#: dozen warm calls, of which the check takes ``CHECK_COLD_CALLS`` as a
#: run's does
WINDOW_CALLS = {False: harness.CHECK_COLD_CALLS, True: 12}


def control_answers(lanes, mix, stop: int, dtype=torch.bfloat16):
    """(call, answer) of the control for each call below ``stop``, every
    lane as the program's would be served: the reference in ``dtype``, its
    weight summed in ``dtype``, each warm call seeded with its own previous
    answer."""
    ctl = [Reference(p.row, p.col, p.n, dtype=dtype) for p in lanes]
    stream, prev = Stream(mix, lanes), None
    for k in range(stop):
        warm = stream.warm(k)
        out = []
        for b, (ref, val, p) in enumerate(zip(ctl, stream.next(), lanes)):
            ans = ref.warm(val, prev[b].mate_row, prev[b].mate_col) if warm \
                else ref.cold(val)
            out.append(Served(mate_row=ans.mate_row, mate_col=ans.mate_col,
                              rounds=ans.rounds, perfect=ans.perfect(),
                              weight=float(ans.u[:-1].sum()),
                              issues=frozenset(preflight_issues(
                                  p.row, p.col, val.to(dtype), p.n))))
        prev = out
        yield k, out


def hold(seed: int, mix, window: range, answers) -> harness.Held:
    """The answers a run's check would hold of (call, answer) pairs, the
    calls before ``window`` being the set-up's."""
    held = harness.Held(seed, mix.warm_start)
    for k, answer in answers:
        if k < window.start:
            held.warmed(k, answer)
        else:
            held.add(k, answer, k == window[-1])
    return held


def readings(spec: dict, name: str, seed: int, device: torch.device,
             config: dict | None = None) -> dict:
    """The program's, the control's and the stale answer's compared
    numbers for one seed."""
    from repro_torch.core import api

    _, config, mix = harness.resolve(spec, name, config)
    lanes = make_lanes(config, seed, device)
    window = range(mix.warmup_calls,
                   mix.warmup_calls + WINDOW_CALLS[mix.warm_start])
    caller = harness.Caller(api, lanes, "batch" in config,
                            Stream(mix, lanes), device)
    first = caller.call()
    program = hold(seed, mix, window, itertools.chain(
        [(0, first)], ((k, caller.call()) for k in range(1, window.stop))))
    caller.prev = None
    out = {"seed": seed, "calls": len(window), "lanes": len(lanes)}
    for label, held in (
            ("program", program),
            ("control", hold(seed, mix, window,
                             control_answers(lanes, mix, window.stop))),
            ("stale", hold(seed, mix, window,
                           ((k, first) for k in range(window.stop))))):
        tally = harness.check(lanes, mix, held)
        out[label] = tally.numbers()
        out[label + "_checked"] = tally.checked
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
