#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[paper_eval]`` phase alone, on the card.

Builds the kernels and runs the paper's evaluation as
``chip_smoke.phase_paper_eval`` does: ``DEFAULT_SPEC``, three suite
matrices of n = 4,096, then ``python -m repro_torch.experiments
--download`` over the synthetic stand-ins for the paper's SuiteSparse
instances and again over the filled cache, every row held as there, on
the 1x1 NCCL grid, which it starts and stops itself. About a minute
instead of the script's fourteen.

Run from the root of a checkout on a machine with the card:

    python3 tools/paper_eval_phase.py [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paper_eval_phase: no CUDA device is available",
              file=sys.stderr)
        return 2
    log = {}
    chip_smoke.phase_build(log)
    kernels = {name: {"launches": 0}
               for name in ("awac_sweep", "awac_persistent")}
    t0 = time.perf_counter()
    try:
        chip_smoke.phase_paper_eval(log, kernels)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    print(f"[paper_eval] phase {time.perf_counter() - t0:.1f} s; launches "
          f"K1 {kernels['awac_sweep']['launches']}, K2 "
          f"{kernels['awac_persistent']['launches']} ({log['card']})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"log": log, "kernels": kernels},
                                       indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
