"""Serving launcher, on one device: prefill and greedy decode of the
transformer (the port of the JAX package's ``launch/serve.py``), and
bert4rec's next-item scoring and retrieval (the port of its
``examples/serve_bert4rec.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --prompt-len 16 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --batch 4 --prompt-len 2048 --decode-steps 32

The first runs the smoke-size config (``qwen2-0.5b-smoke``) on the CPU;
the second qwen2-0.5b at full width and depth on the card. ``--arch
qwen2-moe-a2.7b`` serves the MoE model with its config's router, the
top-k baseline; ``serve_lm(get_config("qwen2-moe-a2.7b", router="awpm"),
...)`` serves it with the AWPM router, as the JAX package selects it.
The JAX launcher declares ``--reduced`` as ``store_true`` with
``default=True``, so it can never run full width; here ``--no-reduced``
does. Without
``--device`` the run goes to the card and fails where there is none.
The launcher serves prefill attention through the CUDA kernel
(``attention_impl="cuda"``); on the CPU the kernel's wrapper takes its
plain version.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec \\
      --device cpu

serves bert4rec's smoke size (``serve_recsys``); with ``--no-reduced
--batch 512`` on the card, its published size at the ``serve_p99`` batch.
The JAX launcher refuses the recsys family and points to its example;
this one dispatches by family.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import recsys_shape
from repro_torch.core.single import resolve_device
from repro_torch.models import build_defs
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeResult:
    ids: torch.Tensor  # [B, decode_steps] generated token ids, int64
    prefill_ms: float
    decode_ms: float  # per token, for the whole batch
    last_logits: torch.Tensor  # [B, V] float32, the prefill's


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int = 0):
    """The prompt [B, prompt_len] int64 drawn with numpy from ``seed`` (the
    JAX launcher's draw for seed 0)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64))


def grow_cache(cache, cfg, smax: int):
    """The prefill's cache, every group of it, copied into zeroed caches
    of ``smax`` positions, for the decode steps to fill."""
    grown = {}
    for name, kvs in cache.items():
        _, b, s = kvs[0].shape[:3]
        (shape, dtype), _ = T.cache_shapes(cfg, b, smax)[name]
        full = []
        for kv in kvs:
            full.append(torch.zeros(shape, dtype=dtype, device=kv.device))
            full[-1][:, :, :s] = kv
        grown[name] = tuple(full)
    return grown


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve_lm(cfg, batch: int, prompt_len: int, decode_steps: int,
             device=None, seed: int = 0, model: T.LM | None = None
             ) -> ServeResult:
    """Prefill a seeded prompt, grow the cache to ``prompt_len +
    decode_steps`` and decode greedily; prints prefill ms and decode
    ms/token. ``device=None`` means the card (raising without one). The
    weights are drawn from ``seed`` on that device unless ``model`` (on
    that device) is given."""
    dev = resolve_device(device)
    # the tied head is a float32 product, as in the JAX package: keep it in
    # full float32 on the card (TF32 would keep 10 bits of mantissa)
    torch.backends.cuda.matmul.allow_tf32 = False
    if model is None:
        model = build_defs(cfg, device=dev, seed=seed)
    elif model.embed.device.type != dev.type:
        raise ValueError(f"the model lies on {model.embed.device}, not {dev}")
    tokens = prompt_tokens(cfg, batch, prompt_len, seed).to(dev)
    smax = prompt_len + decode_steps
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(model, tokens, cfg)
    cache = grow_cache(cache, cfg, smax)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"prefill: {batch}x{prompt_len} in {prefill_ms:.0f} ms")
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        lg, cache = T.decode_step(model, cache, tok, prompt_len + i, cfg)
        tok = lg.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(decode_steps - 1, 1)
    ids = torch.cat(out, 1)
    print(f"decode: {decode_ms:.1f} ms/token/batch; "
          f"sample ids {ids[0, :8].tolist()}")
    return ServeResult(ids=ids, prefill_ms=prefill_ms, decode_ms=decode_ms,
                       last_logits=logits)


@dataclasses.dataclass
class RecSysResult:
    scores: torch.Tensor  # [B, padded_items] float32, next-item scores
    top_items: torch.Tensor  # [B] int64, the best-scored item of each row
    serve_ms: float  # one serve_scores call on the batch
    candidates: torch.Tensor  # [Nc] int64
    retrieval: torch.Tensor  # [1, Nc] float32, the first sequence's scores
    retrieval_top: torch.Tensor  # [5] int64, its best candidates
    retrieval_ms: float


def recsys_requests(cfg, batch: int, seed: int = 0):
    """(item sequences [B, seq_len], distinct candidate items [Nc]), int64,
    drawn with numpy from ``seed`` in the JAX example's order; Nc is the
    ``retrieval_cand`` cell's count, at most the whole catalogue."""
    n_candidates = min(recsys_shape("retrieval_cand").d("n_candidates"),
                       cfg.n_items)
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, cfg.n_items, (batch, cfg.seq_len))
    cands = rng.choice(cfg.n_items, n_candidates, replace=False)
    return (torch.from_numpy(seqs.astype(np.int64)),
            torch.from_numpy(cands.astype(np.int64)))


@torch.no_grad()
def serve_recsys(cfg, batch: int, device=None, seed: int = 0,
                 model=None) -> RecSysResult:
    """bert4rec serving: next-item scores of a seeded [batch, seq_len]
    batch over the whole item table, timed, with each row's top item; then
    the first sequence against a seeded candidate set
    (``recsys_requests``), timed, with its top five. Prints both.
    ``device=None`` means the card (raising without one); the weights are
    drawn from ``seed`` on that device unless ``model`` (on that device)
    is given."""
    dev = resolve_device(device)
    # the logits are a float32 product, as in the JAX package: keep it in
    # full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    if model is None:
        model = build_defs(cfg, device=dev, seed=seed)
    elif model.items.device.type != dev.type:
        raise ValueError(f"the model lies on {model.items.device}, not {dev}")
    seqs, cands = (x.to(dev) for x in recsys_requests(cfg, batch, seed))
    _sync(dev)
    t0 = time.perf_counter()
    scores = model.serve_scores(seqs)
    top = scores.argmax(-1)
    _sync(dev)
    serve_ms = (time.perf_counter() - t0) * 1e3
    print(f"serve: batch={batch} seq={cfg.seq_len} -> scores "
          f"{tuple(scores.shape)}, {serve_ms:.1f} ms/batch; top items "
          f"{top[:8].tolist()}")
    t0 = time.perf_counter()
    r = model.retrieval_scores(seqs[:1], cands)
    best = cands[torch.argsort(r[0], descending=True, stable=True)[:5]]
    _sync(dev)
    retrieval_ms = (time.perf_counter() - t0) * 1e3
    print(f"retrieval: 1 user x {cands.numel()} candidates -> top-5 "
          f"{best.tolist()}, {retrieval_ms:.1f} ms")
    return RecSysResult(scores=scores, top_items=top, serve_ms=serve_ms,
                        candidates=cands, retrieval=r, retrieval_top=best,
                        retrieval_ms=retrieval_ms)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the smoke-size config (default); --no-reduced "
                         "runs the published width and depth")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "recsys":
        serve_recsys(cfg, args.batch, device=args.device)
        return
    if cfg.family != "lm":
        raise SystemExit(f"the serving launcher serves the LM and recsys "
                         f"families; {args.arch} is of the {cfg.family} "
                         f"family")
    cfg = dataclasses.replace(cfg, attention_impl="cuda")
    serve_lm(cfg, args.batch, args.prompt_len, args.decode_steps,
             device=args.device)


if __name__ == "__main__":
    main()
