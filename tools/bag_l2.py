#!/usr/bin/env python3
"""Where the EmbeddingBag kernel's (K6) time goes on the card, and how much
of the table the L2 cache keeps hot.

Builds the kernels of a checkout (this one, or ``--root``, such as the
parent commit unpacked beside it) and times its K6 wrapper on bert4rec's
item table (1,000,448 x 64 float32, 256 MB) with ``chip_smoke.py``'s
helpers:

  - the ``serve_p99`` bags (512 x 200) and the ``serve_bulk`` bags
    (262,144 x 200), 10% of the entries padding: CUDA events around one
    call (median of 21) and the device time of one call in a CUDA graph
    of 20 calls, beside ``torch.nn.functional.embedding_bag``;
  - the L2 yardstick: the bulk bags with each index folded into a window
    of the table's first rows (``idx % window_rows``), windows of 4 to
    64 MB, so that the same 12.08 GB are gathered from rows the L2 can
    hold;
  - for a checkout whose wrapper chooses a route (``plan_route``): the
    chosen plans, route B's split at ``serve_bulk`` (``chip_smoke.py``'s
    ``bag_bulk_split``), and the bulk bags under other windows of the
    sweep and the p99 bags under other slice counts, each held to the
    plain version.

Run from the root of a checkout on a machine with the card:

    python3 tools/bag_l2.py [--root CHECKOUT] [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
WINDOWS_MB = (4, 8, 12, 16, 24, 32, 40, 48, 64)
TOL = 1e-5


def inputs(cs, get_config, recsys_shape, dev):
    """(table, {shape: (idx, w)}) as ``chip_smoke.py`` draws them."""
    cfg = get_config("bert4rec")
    gen = torch.Generator(device=dev).manual_seed(cs.BAGS["seed"])
    table = torch.randn((cfg.padded_items, cfg.embed_dim), generator=gen,
                        device=dev).mul_(0.02)
    bags = {}
    for name in ("serve_p99", "serve_bulk"):
        b = recsys_shape(name).d("batch")
        idx = torch.randint(0, cfg.n_items, (b, cfg.seq_len), generator=gen,
                            device=dev)
        bags[name] = cs.padded_bags(idx, gen, cs.BAGS["pad"])
    return table, bags


def bag_ptxas(log: str) -> list[str]:
    """The ptxas lines of ``embedding_bag.cu``: each kernel, its registers
    and spills."""
    part = log.split("== embedding_bag.cu")[-1].split("\n== ")[0]
    return [ln.strip() for ln in part.splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill"))]


def held(cs, fn, idx, w, table, what):
    """``fn()`` held to the plain version within TOL."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain

    got = fn()
    want = embedding_bag_plain(idx, w, table)
    err = float((got - want).abs().max())
    cs.require(torch.allclose(got, want, rtol=TOL, atol=TOL),
               f"{what}: kernel differs from plain by {err}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=HERE,
                    help="checkout whose K6 is measured")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bag_l2: no CUDA device is available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import recsys_shape
    from repro_torch.kernels import backend
    import repro_torch.kernels.embedding_bag  # noqa: F401

    k6mod = sys.modules["repro_torch.kernels.embedding_bag.embedding_bag"]
    # chip_smoke.py of this checkout, over the port imported above
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs

    log = dict(root=str(root))
    cs.phase_build(log)  # prints the card's name and power limit
    log["ptxas"] = bag_ptxas(backend.BUILD_INFO.get("ptxas", ""))
    for ln in log["ptxas"]:
        print(f"[build] embedding_bag.cu: {ln}")
    dev = torch.device("cuda")
    table, bags = inputs(cs, get_config, recsys_shape, dev)
    v, d = table.shape
    plan_route = getattr(k6mod, "plan_route", None)

    for name, (idx, w) in bags.items():
        def call(idx=idx, w=w):
            return k6mod.embedding_bag(idx, w, table)

        err = held(cs, call, idx, w, table, name)
        lib_idx = idx.clamp(0, v - 1)
        lib_w = torch.where(idx >= 0, w, 0.0)

        def library(lib_idx=lib_idx, lib_w=lib_w):
            return torch.nn.functional.embedding_bag(
                lib_idx, table, mode="sum", per_sample_weights=lib_w)

        nbytes, ops, gathered = cs.bag_bytes(idx, d, v)
        row = dict(shape=list(idx.shape), max_abs_err=err,
                   event_ms=cs.event_ms(call, 21), graph_ms=cs.graph_ms(call),
                   library_graph_ms=cs.graph_ms(library),
                   bound_ms=cs.bound_ms(nbytes, ops)[0],
                   gathered_gb=gathered / 1e9)
        if plan_route is not None:
            row["plan"] = dataclasses.asdict(plan_route(*idx.shape, v, d))
        log[name] = row
        print(f"[{name}] {row['shape']}: K6 {row['event_ms']:.4f} ms "
              f"(events, median of 21), device {row['graph_ms']:.4f} ms (CUDA "
              f"graph of 20); F.embedding_bag device "
              f"{row['library_graph_ms']:.4f} ms; bound {row['bound_ms']:.4f}"
              f" ms; gathered {row['gathered_gb']:.3f} GB; max abs err "
              f"{err:.3g}; plan {row.get('plan')}")

    # the L2 yardstick: the bulk bags folded into windows of the table
    idx, w = bags["serve_bulk"]
    row_bytes = d * 4
    log["windows"] = {}
    for mb in WINDOWS_MB:
        rows = mb * 2**20 // row_bytes
        folded = torch.where(idx >= 0, idx % rows, idx).to(torch.int32)

        def call(folded=folded):
            return k6mod.embedding_bag(folded, w, table)

        held(cs, call, folded, w, table, f"window {mb} MB")
        ms = cs.graph_ms(call)
        log["windows"][mb] = ms
        print(f"[l2] bulk bags folded into the first {rows} rows ({mb} MB): "
              f"device {ms:.4f} ms, {log['serve_bulk']['gathered_gb'] / ms:.3f}"
              " TB/s of gathered rows")
        del folded

    if plan_route is not None:
        log.update(cs.bag_bulk_split(table, *bags["serve_bulk"],
                                     plan_route(*idx.shape, v, d)))
        variants(cs, log, k6mod, table, bags)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(log, indent=1))
    print(json.dumps({"ok": True, "card": log["card"]}))
    return 0


def variants(cs, log, k6mod, table, bags):
    """Other plans than the chosen one, each held to the plain version:
    the bulk bags through route B at other windows (the module's
    constant changed here for the measurement alone), with the split of
    one call, and through route A; the p99 bags at other slice counts."""
    v, d = table.shape
    idx, w = bags["serve_bulk"]
    plan_route = k6mod.plan_route
    base = plan_route(*idx.shape, v, d)
    log["variants"] = []
    tries = [dataclasses.replace(base, route="A", slices=1)]
    saved = k6mod.WINDOW_BYTES
    for mb in (16, 32, 64):
        k6mod.WINDOW_BYTES = mb * 2**20
        tries.append(plan_route(*idx.shape, v, d))
    k6mod.WINDOW_BYTES = saved
    p_idx, p_w = bags["serve_p99"]
    p_base = plan_route(*p_idx.shape, v, d)
    p_tries = [dataclasses.replace(p_base, slices=s, bags_per_block=8 // s,
                                   blocks=-(-p_idx.shape[0] * s // 8))
               for s in (1, 2, 4, 8)]
    for what, (ii, ww), plans in (("serve_bulk", (idx, w), tries),
                                  ("serve_p99", (p_idx, p_w), p_tries)):
        for plan in plans:
            def call(plan=plan, ii=ii, ww=ww):
                return k6mod._launch(ii, ww, table, plan)

            held(cs, call, ii, ww, table, f"{what} {plan}")
            row = dict(shape=what, plan=dataclasses.asdict(plan),
                       graph_ms=cs.graph_ms(call))
            text = ""
            if plan.route == "B":
                split = torch.zeros((plan.blocks, 4), dtype=torch.int64,
                                    device=table.device)
                k6mod._launch(ii, ww, table, plan, split)
                us = split.double().mean(0).div(1e3).tolist()
                row["split_us"] = dict(zip(("sort", "wait", "walk", "write"),
                                           us))
                text = "; split " + ", ".join(
                    f"{k} {x:.1f}" for k, x in row["split_us"].items())
            log["variants"].append(row)
            print(f"[variant] {what} {plan}: device {row['graph_ms']:.4f} ms"
                  f"{text}")


if __name__ == "__main__":
    sys.exit(main())
