"""Render the dry run's records (``results/torch/dryrun/*.json``) as the
roofline and dry-run tables (the port of the JAX package's
``roofline/report.py``; the same tables, over the port's records).

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single] [--table summary]

The terms are the H100's (``roofline_terms(hw=H100)``); the column that
JAX headed "compile" holds the trace's seconds.
"""
from __future__ import annotations

import argparse
import json
import pathlib

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch" \
    / "dryrun"


def load(mesh="single", results=None):
    recs = []
    for p in sorted(pathlib.Path(results or RESULTS).glob(f"*__{mesh}.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1.0:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs):
    lines = [
        "| arch | shape | mode | compute | memory | collective | dominant |"
        " peak/dev | MF ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | FAIL: "
                         f"{r.get('error', '?')[:60]} | | | | | |")
            continue
        rl = r["roofline"]
        mfr = r.get("model_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r.get('mode')} "
            f"| {fmt_s(rl['compute_s'])} | {fmt_s(rl['memory_s'])} "
            f"| {fmt_s(rl['collective_s'])} | **{rl['dominant']}** "
            f"| {r['peak_memory_per_device'] / 2**20:.0f}+"
            f"{r.get('temp_bytes', 0) / 2**30:.1f}G "
            f"| {mfr:.2f} |" if mfr else
            f"| {r['arch']} | {r['shape']} | {r.get('mode')} "
            f"| {fmt_s(rl['compute_s'])} | {fmt_s(rl['memory_s'])} "
            f"| {fmt_s(rl['collective_s'])} | **{rl['dominant']}** "
            f"| {r['peak_memory_per_device'] / 2**20:.0f}MB | - |"
        )
    return "\n".join(lines)


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | chips | trace | flops/dev | "
        "bytes/dev | coll bytes/dev (ag/ar/a2a/rs/cp) | status |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r.get('chips', '-')} | - | - | - | - | FAIL |")
            continue
        cb = r["collectives"]["bytes"]
        coll = "/".join(f"{cb[k] / 2**20:.0f}M" for k in
                        ("all-gather", "all-reduce", "all-to-all",
                         "reduce-scatter", "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
            f"| {r.get('trace_s', '-')}s | {r['flops_per_device']:.2e} "
            f"| {r['bytes_per_device']:.2e} | {coll} | OK |")
    return "\n".join(lines)


def summary(recs, mesh):
    ok = sum(1 for r in recs if r.get("ok"))
    lines = [f"{mesh}: {ok}/{len(recs)} cells OK"]
    for r in recs:
        if not r.get("ok"):
            lines.append(f"  FAIL {r['arch']} {r['shape']}: {r.get('error')}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun", "summary"])
    args = ap.parse_args(argv)
    recs = load(args.mesh)
    if args.table == "roofline":
        print(roofline_table(recs))
    elif args.table == "dryrun":
        print(dryrun_table(recs))
    else:
        print(summary(recs, args.mesh))


if __name__ == "__main__":
    main()
