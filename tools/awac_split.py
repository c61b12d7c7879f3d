#!/usr/bin/env python3
"""Where the AWAC kernels' time goes on the card: the persistent loop (K2)
by round and by phase, beside the sweep (K1) and K2 by CUDA events.

Builds the two AWAC sources of a checkout (this one, or ``--root``, such
as the parent commit unpacked beside it) with the persistent kernel
patched at build time, never in the checkout: block 0 stamps
``%globaltimer`` when the kernel starts and after every ``grid.sync()``.
Then, on the states ``chip_smoke.py`` measures (its one instance at
n = 2^20 and its batch of 16 at n = 2^16, both at their MCM states), and
with ``chip_smoke.py``'s timing helpers:

  - K1: CUDA events around one call, median of 21, and the device time
    of each launch (``torch.profiler``); a checkout whose K1 keeps a
    scratch across calls is also timed as a later round's call;
  - K2: CUDA events around one call at ``max_iter=1`` and to
    convergence, median of 5, and the phase split of one run of each
    from the stamps;
  - the persistent kernel's resident blocks per SM (the occupancy query)
    and the ptxas lines of both sources.

Both kernels are held bit for bit against their plain versions. Run from
the root of a checkout on a machine with the card:

    python3 tools/awac_split.py [--root CHECKOUT] [--out FILE]

It needs one card; the stamps add one global store per grid sync.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import pathlib
import re
import shutil
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
AWAC = ("awac_sweep.cu", "awac_persistent.cu")
MAX_STAMPS = 4096

STAMP_HEAD = """
__device__ unsigned long long awac_split_stamp[%d];
__device__ int awac_split_count;
__device__ __forceinline__ void awac_split_mark() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    const int i = awac_split_count;
    if (i < %d) awac_split_stamp[i] = t;
    awac_split_count = i + 1;
  }
}
""" % (MAX_STAMPS, MAX_STAMPS)

STAMP_TAIL = """
extern "C" int awac_split_read(unsigned long long* out, int* count) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err) return err;
  if ((err = cudaMemcpyFromSymbol(count, awac_split_count, sizeof(int))))
    return err;
  if ((err = cudaMemcpyFromSymbol(out, awac_split_stamp,
                                  sizeof(unsigned long long) * %d)))
    return err;
  const int zero = 0;
  return cudaMemcpyToSymbol(awac_split_count, &zero, sizeof(int));
}

extern "C" int awac_split_occupancy(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, awac_loop_kernel, kThreads, 0);
}
""" % MAX_STAMPS


def patch_persistent(text: str) -> str:
    """The persistent source with block 0's stamps after the kernel's
    start and every grid sync, and the two C entries that read them."""
    start = "cg::grid_group grid = cg::this_grid();"
    if text.count(start) != 1 or "grid.sync();" not in text:
        raise RuntimeError("awac_persistent.cu: no grid sync to stamp")
    text = text.replace(start, start + " awac_split_mark();")
    text = text.replace("grid.sync();", "grid.sync(); awac_split_mark();")
    head = text.index("namespace {")
    return text[:head] + STAMP_HEAD + "\n" + text[head:] + STAMP_TAIL


def load_stamped(root: pathlib.Path, build_dir: pathlib.Path):
    """Import the port of ``root``, build its AWAC sources with the
    persistent one stamped, and make its wrappers launch them. Returns
    (the port's backend module, the library)."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import backend

    csrc = build_dir / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(backend.CSRC, csrc)
    src = csrc / "awac_persistent.cu"
    src.write_text(patch_persistent(src.read_text()))
    backend.SOURCES = AWAC
    backend.SIGNATURES = {k: v for k, v in backend.SIGNATURES.items()
                          if k.startswith("awac_")}
    backend.CSRC = csrc
    backend.BUILD_ROOT = build_dir
    lib = backend.library()
    lib.awac_split_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.awac_split_occupancy.argtypes = [ctypes.c_void_p]
    return backend, lib


def stamps(lib, fn) -> list[float]:
    """Microseconds between block 0's stamps over one run of ``fn``."""
    out = (ctypes.c_ulonglong * MAX_STAMPS)()
    count = ctypes.c_int(0)
    lib.awac_split_read(out, ctypes.byref(count))  # clear
    fn()
    err = lib.awac_split_read(out, ctypes.byref(count))
    if err:
        raise RuntimeError(f"awac_split_read failed: {err}")
    t = list(out[:min(count.value, MAX_STAMPS)])
    return [(b - a) / 1e3 for a, b in zip(t, t[1:])]


def split_rounds(deltas: list[float], rounds: int) -> dict:
    """The stamp deltas as (start, per-round phases); a round of five
    syncs (the kernel before the four-sync design) or of four."""
    per = deltas[1:]
    syncs = len(per) // rounds if rounds else 0
    names = {5: ["sweep", "step D", "survivors", "augment", "bookkeeping"],
             4: ["sweep", "step D", "survivors", "augment+bookkeeping"],
             }.get(syncs, [f"phase {i + 1}" for i in range(syncs)])
    return dict(start_us=sum(deltas[:1]), syncs_per_round=syncs,
                rounds=[dict(zip(names, per[r * syncs:(r + 1) * syncs]))
                        for r in range(rounds)])


def states(cs, dev):
    """(label, kernel inputs, n, window_steps) of the states chip_smoke.py
    measures the AWAC kernels on."""
    g = cs.single_graph()
    row, col, val = (torch.from_numpy(x).to(dev) for x in (g.row, g.col,
                                                             g.val))
    n = g.n
    st = cs.single.greedy_maximal(row, col, val, n)
    st = cs.single.mcm(row, col, val, n, st.mate_row, st.mate_col)
    args, ws = cs.single_inputs(row, col, val, n, st)
    yield "single", args, n, ws
    del row, col, val, st, args
    pb = cs.MatchingProblem.stack(cs.batch_graphs())
    args, ws = cs.batch_inputs(pb.row, pb.col, pb.val, pb.n)
    yield "batch", args, pb.n, ws


def measure(cs, lib, label, args, n, ws) -> dict:
    """K1 and K2 on one state, each held to its plain version."""
    from repro_torch.kernels.cycle_gain import awac_sweep, persistent

    dev = args[0].device
    mg = torch.tensor(cs.MIN_GAIN, dtype=torch.float32, device=dev)
    go = torch.ones(args[0].shape[0], dtype=torch.bool, device=dev)

    def k1():
        return awac_sweep.awac_sweep_batched(*args, mg, n=n, window_steps=ws)

    def k2(max_iter):
        return lambda: persistent.awac_persistent_batched(
            *args, mg, go, n=n, window_steps=ws, max_iter=max_iter)

    want1 = awac_sweep.awac_sweep_plain(*args, mg, n=n, window_steps=ws)
    want2 = persistent.awac_persistent_plain(*args, mg, go, n=n,
                                             window_steps=ws, max_iter=1000)
    rounds = int(want2[4].max())
    cs.assert_identical(k1(), want1, f"{label}: K1 vs plain")
    cs.assert_identical(k2(1000)(), want2, f"{label}: K2 vs plain")
    out = dict(rounds=want2[4].tolist(), k1_ms=cs.event_ms(k1, 21),
               k1_split=cs.launch_split(k1))
    print(f"[{label}] K1 {out['k1_ms']:.3f} ms (events, median of 21); "
          f"{cs.split_text(out['k1_split'])}")
    if "scratch" in inspect.signature(
            awac_sweep.awac_sweep_batched).parameters:
        later, _ = cs.sweep_calls(args, mg, n, ws)
        cs.assert_identical(later(), want1, f"{label}: K1 (kept) vs plain")
        out.update(k1_later_ms=cs.event_ms(later, 21),
                   k1_later_split=cs.launch_split(later))
        print(f"[{label}] K1 as a later round's call {out['k1_later_ms']:.3f}"
              f" ms; {cs.split_text(out['k1_later_split'])}")
    for name, max_iter, n_rounds in (("max_iter=1", 1, 1),
                                     ("converged", 1000, rounds)):
        fn = k2(max_iter)
        ms = cs.event_ms(fn, 5)
        split = split_rounds(stamps(lib, fn), n_rounds)
        out[f"k2_{name}"] = dict(ms=ms, split=split)
        print(f"[{label}] K2 {name}: {ms:.3f} ms (events, median of 5); "
              f"start {split['start_us']:.1f} us")
        for r, ph in enumerate(split["rounds"]):
            parts = ", ".join(f"{k} {v:.1f}" for k, v in ph.items())
            print(f"[{label}]   round {r + 1}: {sum(ph.values()):.1f} us = "
                  f"{parts}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose AWAC kernels are measured")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("awac_split: no CUDA device is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    tag = re.sub(r"[^A-Za-z0-9]+", "-", str(root)).strip("-")[-40:]
    backend, lib = load_stamped(root, HERE / "build" / f"awac-split-{tag}")
    # chip_smoke.py of this checkout, over the port imported above
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    ptxas = [ln.strip() for ln in backend.BUILD_INFO.get("ptxas", "")
             .splitlines() if any(w in ln for w in ("entry function",
                                                    "registers", "spill"))]
    per_sm = ctypes.c_int(0)
    lib.awac_split_occupancy(ctypes.byref(per_sm))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = dict(root=str(root), ptxas=ptxas, k2_blocks_per_sm=per_sm.value)
    cs.phase_build(log)  # prints the card's name and power limit
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")
    print(f"[build] awac_loop_kernel: {per_sm.value} resident blocks per SM "
          f"x {sms} SMs")
    for label, kargs, n, ws in states(cs, torch.device("cuda")):
        log[label] = measure(cs, lib, label, kargs, n, ws)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(log, indent=1))
    print(json.dumps({"ok": True, "card": log["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
