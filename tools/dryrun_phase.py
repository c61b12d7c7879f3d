#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[dryrun]`` phase alone, on the card.

Runs the whole dry run in a child process and the five cells one card
holds, traced on ``meta`` and run on the card, as
``chip_smoke.phase_dryrun`` does, without the rest of the chip check.
TF32 stays off, as in ``chip_smoke.py``. The kernels are built first.

Run from the root of a checkout on a machine with the card:

    python3 tools/dryrun_phase.py [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dryrun_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    log = {"card": card}
    t0 = time.perf_counter()
    chip_smoke.backend.library()
    started = chip_smoke.dryrun_start()
    try:
        chip_smoke.phase_dryrun(log, started)
    finally:
        chip_smoke.dryrun_stop(started)
    print(f"[dryrun] {time.perf_counter() - t0:.1f} s ({card})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(log, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
