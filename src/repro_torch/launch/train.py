"""Training launcher, on one device (the port of the JAX package's
``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --device cpu --steps 20 [--router awpm] [--ckpt-dir DIR]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --no-reduced --steps 5 --batch 4 --seq 2048

The LM family trains on ``TokenPipeline`` streams, the recsys family
(bert4rec) on the JAX launcher's masked-item batches; the weights are
drawn from seed 0 and the prefill attention goes through the
flash-attention kernel (on the card; its plain version on the CPU), with
the plain recomputation's gradients. Without ``--device`` the run goes
to the card and fails where there is none. ``--reduced`` is the smoke
size and the default; unlike the JAX launcher, whose ``store_true`` flag
cannot be turned off, ``--no-reduced`` runs the published width and depth.
``--grad-accum`` is passed to the train step (the JAX launcher parses it
and drops it); a graph batch has no leading axis to cut, so the train
step refuses ``--grad-accum > 1`` for the GNN family.

The GNN family trains on the JAX launcher's synthetic graphs: 128 nodes,
512 edges and 16 features a step (with coordinates for dimenet and
equiformer-v2, and triplets for dimenet), 7 classes; graphcast on
256-node grids. Its model is built for the first GNN shape cell with
``d_feat`` 16 (``gnn_train_shape``), as the JAX launcher overrides it:

  PYTHONPATH=src python -m repro_torch.launch.train --arch dimenet \
      --device cpu --steps 2
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import GNN_SHAPES, ShapeSpec
from repro_torch.core.single import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import build_defs, build_loss
from repro_torch.models.param import count_params
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig


def _data_fn(cfg, batch, seq, seed=0):
    """step -> a batch of numpy arrays, the JAX launcher's streams."""
    if cfg.family == "lm":
        pipe = TokenPipeline(cfg.vocab, batch, seq, seed=seed)
        return pipe.batch
    if cfg.family == "recsys":
        def fn(step):
            rng = np.random.default_rng((seed, step))
            seqs = rng.integers(0, cfg.n_items, (batch, cfg.seq_len))
            mask = (rng.random((batch, cfg.seq_len)) < 0.2)
            return {"item_seq": seqs.astype(np.int32),
                    "labels": seqs.astype(np.int32),
                    "mask": mask.astype(np.float32)}
        return fn
    if cfg.family == "gnn":
        from repro_torch.data import graphs as G

        def fn(step):
            if cfg.kind == "graphcast":
                return G.random_graphcast_batch(256, cfg.opt("n_vars", 12),
                                                seed=step)
            return G.random_graph(
                128, 512, 16, n_classes=7, seed=step,
                coords=cfg.kind in ("dimenet", "equiformer_v2"),
                triplets=cfg.kind == "dimenet")
        return fn
    raise ValueError(f"unknown family {cfg.family!r}")


def gnn_train_shape() -> ShapeSpec:
    """The shape cell a GNN trains at here: the first GNN cell, with the
    synthetic graphs' 16 features (the JAX launcher's override)."""
    return ShapeSpec(GNN_SHAPES[0].name, "train", (("d_feat", 16),))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the smoke-size config (default); --no-reduced "
                         "runs the published width and depth")
    ap.add_argument("--router", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    kw = {"router": args.router} if args.router else {}
    cfg = get_config(args.arch, reduced=args.reduced, **kw)
    if cfg.family == "lm":
        cfg = dataclasses.replace(cfg, attention_impl="cuda")
    device = resolve_device(args.device)
    shape = gnn_train_shape() if cfg.family == "gnn" else None
    model = build_defs(cfg, shape, device=device, seed=0)
    print(f"{cfg.name}: {count_params(model) / 1e6:.2f}M params on {device}")
    mgr = CheckpointManager(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    data_fn = _data_fn(cfg, args.batch, args.seq)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    _, _, hist = train(model, build_loss(cfg), data_fn, opt,
                       n_steps=args.steps, log_every=10, checkpoint_mgr=mgr,
                       checkpoint_every=max(args.steps // 2, 1),
                       straggler_monitor=StragglerMonitor(),
                       grad_accum=args.grad_accum)
    if mgr:
        mgr.wait()
    print(f"final loss {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
