#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[dense_lm]`` phase alone, on the card.

Builds the kernels, then serves qwen2-7b and qwen1.5-110b (6 of its 80
layers) at full width as ``chip_smoke.phase_dense_lm`` does (K5 once per
layer of each prefill, the logits held to the plain attention and to the
float32 model, model FLOPs, profiles, the smoke model on the card
against the CPU), without the rest of the chip check. ``--flash`` runs
``[flash]`` first (K5 at every served head shape against its plain
version, timed beside SDPA); ``--train`` runs ``[train]`` after it
(qwen2-0.5b's compressed gradients and the resharded restore, then
bert4rec). TF32 stays off, as in ``chip_smoke.py``.

Run from the root of a checkout on a machine with the card:

    python3 tools/dense_lm_phase.py [--flash] [--train] [--out FILE]
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

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flash", action="store_true",
                    help="run [flash] before [dense_lm]")
    ap.add_argument("--train", action="store_true",
                    help="run [train] after [dense_lm]")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_lm_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    log = {}
    kernels = {"flash_attention": {"launches": 0}}
    t0 = time.perf_counter()
    chip_smoke.phase_build(log)
    if args.flash:
        chip_smoke.phase_flash(log, kernels)
        chip_smoke.free_card()
    chip_smoke.phase_dense_lm(log, kernels)
    if args.train:
        chip_smoke.phase_train(log, kernels)
    print(f"[dense_lm] {time.perf_counter() - t0:.1f} s ({log['card']})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"log": log, "kernels": kernels},
                                       indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
