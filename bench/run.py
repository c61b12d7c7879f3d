"""Run one cell of the port's benchmark once, on the card this machine
holds, and print its result as the last line of standard output.

    python3 bench/run.py --workload powerlaw_2m7.cold --seed 7 --seconds 10 \
        --trace 0

Exits with a code other than 0, printing no result, where no CUDA device
(or fewer than the cell asks for) is present, where the port cannot be
imported, or where JAX or the JAX package was loaded by the time the
window closed. See bench/README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read ({out.stderr.strip()})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[0] = str(ROOT)  # not bench/: its modules are bench.*
    sys.path.insert(1, str(ROOT / "src"))

    import torch

    from bench import harness

    spec = harness.load_spec()
    cell = harness.workload(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, tally = harness.run_cell(spec, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     torch.device("cuda"), T_START)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        harness.log(f"refusing to report: {', '.join(loaded)} loaded in "
                    f"this process")
        return 3
    harness.log(f"card: {power_limit()}")
    for k, v in tally.report().items():
        harness.log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
