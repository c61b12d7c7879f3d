#!/usr/bin/env python3
"""Chip check of the torch port (``src/repro_torch``) on one NVIDIA GPU.

Builds the hand-written CUDA kernels from this checkout, drives the port's
paths — ``solve()`` at the size a sparse direct solver hands to its
matching step, locally and on the 1x1 grid, the matching service with
warm-start rematching over a stream of requests, the resilience layer
(guarded solves, the chaos matrix, a resilient service), the
static-pivoting sparse solver, the measured dispatch table behind
"auto", the paper's evaluation runner, and LM serving (``serve_lm``) on
qwen2-0.5b and on the MoE model qwen2-moe-a2.7b with the AWPM router,
both at full width and depth — then bert4rec serving (``serve_recsys``)
at its published size and the recsys EmbeddingBag and the dense
cycle-gain tile through their public entries, the dense LMs qwen2-7b and
qwen1.5-110b (6 of its 80 layers) at full width, and training of
qwen2-0.5b (with compressed gradients and a resharded restore) and
bert4rec, the GNN family, and the dry run's cells that one card holds —
holds each kernel against its plain torch version on the
card, and prints what it measured:

  1. build the kernels (``nvcc``, sm_90a); print the build time and the
     card's name and power limit;
  2. one instance, n = 1,048,576, avg_degree 16, kind "antigreedy",
     seed 0: ``solve()`` with backend "auto" (must resolve to the
     committed dispatch table's winner, whose kernel's launches are
     checked: the MCM kernel once, and the persistent kernel once or the
     sweep kernel once per round), "cuda" (the MCM kernel once, the sweep
     kernel once per round) and "torch", with identical states and
     iteration counts; the greedy / MCM (its kernel, and the plain
     version's BFS / trace-flip split) / AWAC split; the MCM kernel
     against its plain version from the greedy state, mates and stats bit
     for bit, both timed; the persistent kernel against its plain version,
     timed to convergence and at ``max_iter=1``, with its device time
     from ``torch.profiler``;
  3. a batch of 16 instances, n = 65,536, avg_degree 8, kinds cycling
     through ``SUITE_KINDS``: every lane against its own single-instance
     ``solve()``; both kernels against their plain versions on the batch's
     MCM state, where every lane has candidates, with the median time and
     the bound of each, the sweep's device time (a CUDA graph) and its
     launches' times (``torch.profiler``), the persistent kernel at
     ``max_iter=1`` and its device time;
  3a. [dispatch] the committed dispatch table
     (``src/repro_torch/kernels/dispatch_table.json``, written by
     ``tools/dispatch_table.py``): "auto" must resolve to each shape
     class's winner with source "table" (n = 128 alone and in a batch of
     16 here, phases 2 and 3 for the large classes); single_small and
     single_large re-timed as the tool times them (every backend, a later
     call's median of 5) and printed beside the table's entries. The
     launch checks of the later phases read the backend "auto" resolves
     to there;
  3b. [grid] the distributed engine (``core.dist``) on the 1x1 grid of
     one NCCL rank: ``solve()`` of the phase-2 instance with backend
     "auto" (must resolve to "fused", the exchange engine) and "cuda" (the
     sweep kernel once per round), states and rounds identical to phase
     2's; the host's partition time and the greedy / MCM / AWAC split;
     one grid ``solve()`` under ``torch.profiler``; one ``plan()`` and
     two ``Matcher`` calls; an ``exchange_check`` run;
     phase 3's batch on the grid, every lane identical to phase 3;
  3c. [serve] the matching service (``repro_torch.serving``) on the card:
     an open-loop stream of 256 requests from 16 users at n = 4,096
     (degree 16, 4,000 requests/s, 2% weight jitter, an edge dropped in
     one repeat of ten) through ``MatchingService`` with warm start and
     again without, every response perfect, most of them warm, the
     persistent kernel launched on the service's path, and every warm
     response equal to a direct ``solve(warm_start=)`` of its
     class-embedded instance; phase 2's instance served in its exact
     batch-1 class: cold, its unchanged repeat (equal bit for bit after
     one AWAC round) and a perturbed repeat, with the warm split (repair,
     MCM top-up, AWAC), one warm serve under ``torch.profiler`` and the
     warm solve with backend "cuda" (the sweep kernel once per round);
     the perturbed repeat's warm solve on the 1x1 grid, equal to the
     local one; ``certify`` on a served n = 4,096 response and on phase
     5's instance (sound against its exact optimum); static pivoting of 8
     matrices of n = 512 on the card and on the CPU (equal permutations;
     relative errors within 2e-9, printed beside those after the exact
     maximum-product matching);
  3d. [resilient] the guard (``runtime.resilient``) on the card, with
     ``verify`` and ``verify_convergence`` on: phase 2's instance through
     ``resilient_solve`` with "auto", which must be served by "local
     cuda_persistent" at the first try, not degraded, bit for bit as the
     direct ``solve()``; the guard's split (solve, verify with its host
     copies, audit) and ``verify_result`` alone; ``certify=True`` at
     n = 4,096 (the certificate's descent at n = 2^20 would run n rounds
     on the host); the 1x1 grid, which must serve as "grid 1x1 (fused)";
     the persistent kernel failing (served by "local cuda", the sweep
     kernel once per round) and both kernels failing (served by "local
     torch"); phase 3's batch through a ``ResilientMatcher``, twice;
  3e. [chaos] the detect-vs-survive matrix (``runtime.chaos``) on the 1x1
     grid: 28 cases (JAX's 2x4 matrix has 29; one row has no partial
     loss), every record ok, the sweep kernel launched by the
     ``flip_converged`` detect case (backend "cuda") and the persistent
     kernel by the cases that degrade to the local chain;
  3f. [serve] resilient: 3c's stream again through
     ``ServiceConfig(resilient=True)``, every response equal to the
     plain service's (timing fields aside) and naming "local
     cuda_persistent" at the first try; ``solve_s`` per lane with the
     guard and without;
  3g. [solver] the static-pivoting solver (``repro_torch.solver``): six
     Matrix Market fixtures and three planted systems under the arms
     awpm, reference, none and tpp through ``solve_linear_system`` with
     the matching and the triangular sweeps on the card; every awpm row
     at or below a 1e-10 residual, one case at least where the unpivoted
     arm fails and awpm converges; every awpm row launching the
     persistent kernel; flags and sweeps as on the CPU; per row the
     matching, LU and refinement times; then the planted ill-conditioned
     system at n = 4,096 through the awpm arm, with the device operations
     and device time of one float32 solve through its factors;
  3h. [paper_eval] the paper's evaluation (``repro_torch.experiments``):
     ``DEFAULT_SPEC`` (six fixtures, ten suite matrices of n = 96) and
     three suite matrices of n = 4,096 through "reference", "torch",
     "cuda", "cuda_persistent", "auto" and the 1x1 NCCL grid, every row
     certified by its dual, sound, perfect and identical to "reference";
     then the CLI (``python -m repro_torch.experiments``) with
     ``--download`` over three synthetic stand-ins for the paper's
     SuiteSparse instances (n = 4,096, Matrix Market files packed as the
     collection packs them, served from a ``file://`` directory), and
     again over the filled cache with that URL gone: every instance row
     from "suitesparse" in the paper's metric, the two passes equal; the
     rows, the sweep and persistent kernels' launches and the worst
     certified ratio bound;
  4. the sweep kernel alone against its plain version on a mid-AWAC state
     of the phase-2 instance, with the median time of each, its device
     time and its launches' times. In phases 3 and 4 the sweep kernel is
     called as the engines call it in a later round, on a scratch that an
     earlier call on the same edges built (its time is the kernel's
     "ms"), and as a loop's first call, which builds the row records;
     in phase 4 the scratch is built on the MCM state and kept for the
     measured one. Then one ``solve()`` of that instance
     under ``torch.profiler``: the device's busy share and the kernels
     that take its time. Phases 2 to 4 also count the 32-byte sectors
     that the completion lookups touch, a diagnostic beside each bound;
  5. n = 400: ``solve()`` against the exact optimum (ratio >= 2/3);
  6. [lm] qwen2-0.5b (24 layers, d_model 896, bf16, weights drawn from
     seed 0 on the card): ``serve_lm`` with batch 4, a 2,048-token prompt
     and 32 greedy decode steps through the flash-attention kernel, which
     must launch once per layer of the prefill; the same prefill through
     the plain attention, logits compared; the smoke-size model (float32)
     on the card against the same weights on the CPU, ids identical;
     one prefill and four decode steps under ``torch.profiler``;
  7. [flash] K5 against its plain version: the bf16 tensor-core kernel on
     the prefill's shapes, causal and full, a ragged S, D = 16 and 32,
     Sk != S both ways and the model layout's strided views (through
     ``ops.attention``, which must allocate only its output and put K5
     alone on the stream), the float32 CUDA-core kernel on the prefill's
     shape; each path timed there, by CUDA events around one call and by
     a CUDA graph of 20 calls, beside its bound, its plain version and
     ``torch.nn.functional.scaled_dot_product_attention``, and the bf16
     kernel also at the served models' head shapes, causal, each held to
     the plain version: qwen2-moe-a2.7b's q/k/v [4, 16, 2048, 128],
     qwen2-7b's q [4, 28, 2048, 128] over k/v [4, 4, 2048, 128] and
     qwen1.5-110b's q [4, 64, 2048, 128] over k/v [4, 8, 2048, 128] (SDPA
     with ``enable_gqa=True``);
  8. [recsys] bert4rec (embed_dim 64, 2 blocks, 2 heads, seq_len 200, a
     table of 1,000,448 items; float32 weights drawn from seed 0 on the
     card): ``serve_recsys`` at the ``serve_p99`` batch (512), the median
     ms per batch over 10 calls after a warm-up, and the retrieval of one
     user against 1,000,000 candidates; the first 8 sequences' scores and
     the retrieval against the same weights on the CPU; one
     ``serve_scores`` call under ``torch.profiler``; the smoke-size model
     on the card against the CPU. ``serve_bulk`` (batch 262,144) is not
     served: its logits would take 1.05 TB;
  9. [embedding_bag] the EmbeddingBag kernel (K6) through
     ``models.recsys.embedding.embedding_bag(use_kernel=True)`` on the
     served model's own item table: the ``serve_p99`` batch's sequences
     (route A, slices) and a ``serve_bulk``-sized set (262,144 bags of
     200; route B, the window sweep) as bags, 10% of the entries padding,
     one launch a call; each against its plain version within 1e-5 and
     bit for bit against a second call, with bags of padding only and an
     index V through each route; the route and its parameters and the
     kernels' registers and spills; each shape timed by CUDA events and
     by a CUDA graph of 20 calls beside its bound, its plain version and
     ``torch.nn.functional.embedding_bag``; the L2 yardstick (the bulk
     bags folded into the first window, and the windows a block may keep
     hot, through route A) and route B's split of one bulk call into its
     sort, wait, walk and write phases;
 10. [cycle_gain] the dense cycle-gain kernel (K3) through
     ``cycle_gain_padded`` bit for bit against its plain version on
     ``bench_kernels.py``'s 512 x 512 tile, a 16,384 x 16,384 pair at
     density 0.3, a tie-heavy and an all-absent case; through
     ``swap_gains`` at the MoE prefill's group size (T 2,100, E 60);
     timed beside its bound and its plain version;
 11. [moe] qwen2-moe-a2.7b with the AWPM router (24 layers, d_model 2048,
     60 experts top-4 and 4 shared, float32 weights drawn from seed 0 on
     the card, bf16 activations): ``serve_lm`` with batch 4, a 2,048-token
     prompt and 8 greedy decode steps; one prefill counted alone, which
     must launch the router's swap-search kernel (K4) 384 times and the
     flash-attention kernel 24 times, with every layer's router logits
     captured by forward hooks; the AWPM routing of layers 0, 11 and 23
     through K4 against the plain swap search, identical; the top-k router
     on the same weights; one prefill and one decode step under
     ``torch.profiler``; the smoke-size MoE model (float32) on the card
     against the CPU;
 12. [router_swap] K4 against its plain version, bit for bit, on layer 0's
     captured router input at the prefill shape (G = 4, T = 2,100, E = 60)
     and at the decode shape (G = 1, T = 60), on a random (300, 60) case
     and on an odd (T, E) = (1001, 13) with int32 ids; timed beside its
     bound and its plain version, through its wrapper and through the
     router's entry (whose CUDA graph must hold K4 alone), with its device
     time from a CUDA graph of 20 launches and per launch from the prefill
     profile;
 12a. [dense_lm] qwen2-7b (28 layers, d_model 3,584, 28 heads over 4 kv
     heads of 128) and qwen1.5-110b cut to 6 of its 80 layers (d_model
     8,192, 64 heads over 8), each freed before the next is built: float32
     weights drawn from seed 0 on the card, bf16 activations;
     ``serve_lm`` with batch 4, a 2,048-token prompt and 32 (qwen2-7b) or
     8 greedy decode steps, K5 once per layer of the prefill; the prefill
     through the plain attention and in float32, logits compared as in
     [lm]; the prefill's model FLOPs (``roofline.analysis.useful_flops``)
     and their share of the bf16 peak; one prefill and four decode steps
     under ``torch.profiler``; the smoke-size model on the card against
     the CPU;
 13. [train] qwen2-0.5b (24 layers, bf16 compute, float32 weights drawn
     from seed 0) training on ``TokenPipeline`` batches of 4 x 2,048
     tokens through the flash-attention kernel's autograd path: K5 once
     per layer in a forward, and again per layer when the checkpointed
     blocks are recomputed in backward; step 1's loss and every gradient
     leaf against the plain attention path on the same weights and batch
     (``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_TOL``); step 1's gradients through
     ``compress_int8_psum`` on the 1x1 NCCL grid's group and through
     ``compress_topk``, equal bit for bit to the same on the host CPU; 5
     AdamW steps through
     ``training.loop.train`` (the loss on the first batch must fall), with
     ms per step, tokens a second, peak memory and the device's busy share
     over one step; the state after step 5 saved, restored and resharded
     onto the 1x1 grid (``runtime.elastic.reshard_state``), whose sixth
     step must equal the sixth step taken without the round trip, bit for
     bit; then bert4rec at full width, 3 steps at batch 4;
 14. [gnn] the GNN family at its published configs (``models.gnn``):
     graphsage-reddit on blocks sampled from a host graph of Reddit's
     size (232,965 nodes, 114,615,892 edges, 602 features, 41 classes;
     1,024 seeds at fanouts 15/10: 169,984 nodes, 168,960 edges),
     dimenet and equiformer-v2 on 128 molecules of 30 nodes and 64 edges,
     graphcast on 169,984 grid nodes (10,624 mesh nodes). Per arch: at
     2 layers, full width, on a small graph, the card against the CPU
     (step 1's loss within ``GNN_LOSS_TOL``, each gradient leaf within
     ``GNN_GRAD_TOL`` of its largest magnitude); at full depth on the
     cell, a plain gradient step that must lower the loss, then 5 AdamW
     steps through ``training.loop.train`` (finite losses), with ms per
     step, peak memory, the device's busy share and top operations over
     one step, and graphsage's host seconds to build the graph and
     sample. No hand-written kernel is on this path, and none may launch.
 15. [dryrun] the dry-run layer (``repro_torch.launch.dryrun``): the whole
     dry run (``--all --mesh both``) in a child process started after the
     build, so that it traces on the host beside the card's phases, 84
     records that must all be ``ok``, with its host seconds and each
     cell's dominant roofline term; then five cells that one card holds,
     each built by ``launch.input_specs`` on a 1 x 1 mesh with
     ``attention_impl="cuda"`` for the LMs, traced on ``meta`` and then
     run on the card: qwen2-0.5b
     ``prefill_32k`` (32,768 tokens, batch cut from 32 to 1; K5 24 times)
     and ``train_4k`` (4,096 tokens, batch cut from 256 to 2; K5 48
     times, forward and remat), qwen2-7b ``decode_32k`` (a 32,768-token
     cache, batch cut from 128 to 4), bert4rec ``serve_p99`` (batch 512)
     and dimenet ``molecule`` (128 graphs), whole. Per cell: the meta
     FLOPs, which must equal the same counter on the card run; the meta
     peak (arguments and the trace's temp) beside
     ``torch.cuda.max_memory_allocated()`` over the step less what the
     card held beside the arguments before it (the bar is 10%; a miss is
     printed, not failed); the median of 3 later calls (CUDA events)
     beside the roofline's dominant term at one chip. The peaks are the
     cut cells'.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

It needs one card and no network, and exits non-zero without a CUDA device
or outside a checkout. Each phase ends with a ``[time] <phase> <seconds>``
line. Device rows of a ``torch.profiler`` trace are summed from its raw
events (``device_rows``): ``key_averages()`` on the traces of a hundred
thousand launches took minutes. ``tools/stamp_lines.py`` stamps every line
with the seconds since the start, to find where a run's time goes. The
line before the last holds the per-kernel record as JSON; the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as tdist
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ShapeSpec,
    gnn_shape,
    recsys_shape,
    shapes_for,
)
from repro_torch.core import (  # noqa: E402
    MIN_GAIN,
    MatchingProblem,
    MatchState,
    SolveOptions,
    batch,
    certify,
    dist,
    graph,
    make_grid,
    pivot,
    plan,
    ref,
    single,
    solve,
)
from repro_torch.data import graphs as gnn_data  # noqa: E402
from repro_torch.data import mtx as mtx_io  # noqa: E402
from repro_torch.data import suitesparse  # noqa: E402
from repro_torch.experiments import __main__ as paper_eval_cli  # noqa: E402
from repro_torch.experiments import paper_eval  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels import dispatch as kdispatch  # noqa: E402
from repro_torch.kernels.cycle_gain.awac_sweep import (  # noqa: E402
    awac_sweep_batched,
    awac_sweep_plain,
)
from repro_torch.kernels.cycle_gain.cycle_gain import cycle_gain  # noqa: E402
from repro_torch.kernels.cycle_gain.ops import (  # noqa: E402
    cycle_gain_padded,
    swap_gains,
)
from repro_torch.kernels.cycle_gain.persistent import (  # noqa: E402
    awac_persistent_batched,
    awac_persistent_plain,
)
from repro_torch.kernels.cycle_gain.ref import cycle_gain_plain  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_plain  # noqa: E402
# the wrapper module of K6 (its package exports a function of that name)
K6 = importlib.import_module("repro_torch.kernels.embedding_bag.embedding_bag")
from repro_torch.kernels.mcm.persistent import mcm_persistent  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention,
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.router_swap import (  # noqa: E402
    router_swap,
    router_swap_padded_batched,
    router_swap_plain_batched,
)
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    grow_cache,
    prompt_tokens,
    recsys_requests,
    serve_lm,
    serve_recsys,
)
from repro_torch.models import build_defs, build_loss, gnn_out_dim  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.gnn.common import GraphBatch  # noqa: E402
from repro_torch.models.gnn.equiformer_v2 import near_zero_leaves  # noqa: E402
from repro_torch.models.gnn.sampler import build_csr, sample_blocks  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402
from repro_torch.models.recsys import embedding  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import input_specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    attention_work,
    roofline_terms,
    swap_work,
    useful_flops,
)
from repro_torch.serving import (  # noqa: E402
    MatchingService,
    ServiceConfig,
    SizeClass,
    StreamSpec,
    run_stream,
    strip_instance,
)
from repro_torch.runtime.chaos import (  # noqa: E402
    assert_all_ok,
    failing_backend,
    run_chaos_matrix,
)
from repro_torch.runtime.elastic import reshard_state  # noqa: E402
from repro_torch.runtime.resilient import (  # noqa: E402
    ResilientMatcher,
    ResilientOptions,
    resilient_solve,
    verify_result,
)
from repro_torch.serving.loadgen import perturbed  # noqa: E402
from repro_torch.solver import (  # noqa: E402
    CsrMatrix,
    lu_solve_once,
    solve_linear_system,
    sparse_lu,
)
from repro_torch.solver import experiments as solver_experiments  # noqa: E402
from repro_torch.sparse.csr import (  # noqa: E402
    batched_row_ptr_from_sorted,
    row_ptr_from_sorted,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    OptState,
    make_train_step,
    train,
)
from repro_torch.training import grad_compression as gcomp  # noqa: E402
from repro_torch.training.loop import loss_and_grads, to_device  # noqa: E402

SINGLE = dict(n=1_048_576, avg_degree=16.0, kind="antigreedy", seed=0)
BATCH = dict(b=16, n=65_536, avg_degree=8.0)
# [serve]: the stream and the service, at the service's full class width
SERVE_STREAM = dict(requests=256, users=16, n=4096, avg_degree=16.0,
                    rate_rps=4000.0, weight_jitter=0.02, structure_churn=0.1,
                    kind="uniform", seed=0)
# [solver] at scale: the planted ill-conditioned system at an order a
# sparse direct solver meets, past the fixtures' n <= 64
SOLVER_SCALE = dict(n=4096, seed=5)
SERVE_CONFIG = dict(num_shards=4, deadline_s=0.002, max_batch=8)
# static pivoting: relative error of a pivot-free LU after AWPM pivoting.
# On this family the exact maximum-product matching itself reaches 9.05e-10
# (NVIDIA H100 80GB HBM3, 700 W), so the bar sits above it
PIVOT = dict(b=8, n=512, tol=2e-9)
LM = dict(batch=4, prompt_len=2048, decode_steps=32, seed=0)
QWEN2_0_5B_PARAMS = 494_032_768  # count_params(build_defs(cfg)) in JAX
# fewer decode steps than [lm]: the AWPM router's loops run on the host
MOE = dict(batch=4, prompt_len=2048, decode_steps=8, seed=0)
QWEN2_MOE_PARAMS = 14_315_784_192  # count_params(build_defs(cfg)) in JAX
MOE_CHECK_LAYERS = (0, 11, 23)
BERT4REC_PARAMS = 65_142_016  # count_params(build_defs(cfg)) in JAX
# [dense_lm]: (arch, layers kept or None for all, decode steps); prefill
# batch and prompt as [lm]. qwen1.5-110b keeps 6 of its 80 layers: its
# 111.2B float32 parameters take 445 GB, the card 80 GB
DENSE_LM = dict(batch=4, prompt_len=2048, seed=0,
                models=(("qwen2-7b", None, 32), ("qwen1.5-110b", 6, 8)))
# count_params(build_defs(cfg)) in JAX, at the layers kept
DENSE_LM_PARAMS = {"qwen2-7b": 7_615_616_512, "qwen1.5-110b": 10_645_311_488}
RECSYS = dict(reps=10, seed=0, check_rows=8, top=10)
# card against CPU, bert4rec scores: atol as a share of the largest |score|
RECSYS_TOL = 1e-4
# EmbeddingBag: the bags' padding share, the bulk check's chunk of bags
# and the kernel's tolerance against its plain version
# (tests/test_kernels.py:111)
BAGS = dict(pad=0.1, chunk=16_384, tol=1e-5, seed=3)
# dense cycle-gain tiles: (name, M, N, kind)
TILES = (("bench_kernels 512x512 d0.3", 512, 512, "bench"),
         ("16384x16384 d0.3", 16_384, 16_384, "dense"),
         ("ties 4096x4096", 4096, 4096, "ties"),
         ("absent 1000x3000", 1000, 3000, "absent"))
SWAP = dict(t=2100, e=60, seed=4)  # the MoE prefill's routing group
# the smoke-size model on the card against the CPU, float32
SMOKE_TOL = 1e-4
# kernel path against plain attention, last-position logits: atol as a
# share of the largest |logit|. The two paths round bf16 attention outputs
# apart (one bf16 ulp is 2^-8 of a value), and 24 layers of bf16
# residual stream carry such differences to the head.
LM_LOGIT_TOL = 2e-2
# and the kernel path no further from the same model run in float32 than
# this factor times the plain path's distance from it
LM_F32_RATIO = 2.0
# flash attention against its plain version (tests/test_kernels.py:71)
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
CARD = torch.device("cuda")
# [dispatch]: the re-timed classes' later calls, as the tool takes them
DISPATCH = dict(reps=5, limit_s=20.0)
# [paper_eval]: suite matrices at the order [resilient] certifies at
PAPER_EVAL = {"fixtures": False, "synthetic_count": 3, "synthetic_n": 4096}
# [paper_eval]'s third pass: synthetic stand-ins for the paper's SuiteSparse
# instances (none is in the repository) at the same order, one of each
# kind, written as Matrix Market files (the last one symmetric), packed as
# the collection packs them under GROUP and fetched by the CLI's --download
PAPER_STANDINS = dict(n=4096, avg_degree=8.0, seed=7, group="Synthetic",
                      kinds=("circuit", "powerlaw", "banded"))
# [train]: qwen2-0.5b at full size, bf16 compute, the launcher's AdamW
# settings; then bert4rec at full width
TRAIN = dict(batch=4, seq=2048, steps=5, lr=1e-3, seed=0, rec_batch=4,
             rec_steps=3)
# the kernel path's step-1 loss against the plain path's, relative, and
# each gradient leaf's max difference as a share of its largest magnitude
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 2e-2
# compress_topk's share of each gradient leaf kept (the JAX default)
TOPK_FRAC = 0.01
# [gnn]: each GNN arch at its published config on a cell of GNN_SHAPES,
# sized as the JAX package's dry run sizes it; 5 AdamW steps with the
# launcher's settings, as [train]
GNN = dict(steps=5, lr=1e-3, seed=0, check_layers=2, fanouts=(15, 10))
GNN_CELLS = (("graphsage-reddit", "minibatch_lg"), ("dimenet", "molecule"),
             ("equiformer-v2", "molecule"), ("graphcast", "minibatch_lg"))
# the card against the CPU at 2 layers: step 1's loss, relative, and each
# gradient leaf's max difference as a share of its largest magnitude; a
# leaf that is zero but for a norm's 1e-12 (equiformer-v2's trunk,
# ``models.gnn.equiformer_v2.near_zero_leaves``) as a share of the
# model's largest gradient
GNN_LOSS_TOL = 1e-4
GNN_GRAD_TOL = 1e-3
GNN_ZERO_TOL = 1e-5
# the plain gradient step of the descent check: its first-order decrease
# of the loss, as shares of the loss, tried largest first
GNN_DESCENT = (1e-2, 1e-3, 1e-4)
# [dryrun]: the cells one card holds, built on a 1 x 1 mesh: (arch, shape
# cell, its dims cut to fit one card, K5 launches a step or None)
DRYRUN = dict(reps=3, seed=0, peak_tol=0.10, timeout_s=600, cells=(
    ("qwen2-0.5b", "prefill_32k", {"global_batch": 1}, 24),
    ("qwen2-0.5b", "train_4k", {"global_batch": 2}, 48),
    ("qwen2-7b", "decode_32k", {"global_batch": 4}, None),
    ("bert4rec", "serve_p99", {}, None),
    ("dimenet", "molecule", {}, None)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense


def require(cond, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def sync():
    torch.cuda.synchronize()


def wall(fn):
    """(result, seconds) of ``fn()`` ending in a device sync."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(fn, reps: int = 21) -> float:
    """Median host time of one call of ``fn`` (its work up to the return
    of its last launch), with the card idle before each call."""
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    sync()
    return statistics.median(times)


DeviceRow = collections.namedtuple("DeviceRow", "key count us")


def device_rows(prof) -> list[DeviceRow]:
    """A trace's device activity (kernels, copies, memsets) by name, with
    its launches and device microseconds: the rows of device type CUDA
    that ``prof.key_averages()`` gives, summed from the raw events.
    ``key_averages()`` first builds a Python event object for every
    operator and launch of the trace, which for the traces of a hundred
    thousand launches here (a MoE decode step, the solver's sweeps) took
    longer than everything else in their phases."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        count, us = rows.get(e.name(), (0, 0.0))
        rows[e.name()] = (count + 1, us + (e.end_ns() - e.start_ns()) / 1e3)
    return [DeviceRow(k, count, us) for k, (count, us) in rows.items()]


def dev_us(e) -> float:
    """Device time (us) of a ``device_rows`` row."""
    return e.us


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``, host launch work left out: CUDA
    events around the replay of a CUDA graph that holds ``calls`` calls
    (captured after a warm-up call), median of 5 replays, over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = event_ms(graph.replay, 5) / calls
    del graph
    return ms


def graph_node_types(fn) -> list[int]:
    """The node types of a CUDA graph that captures one call of ``fn``
    (``cudaGraphNodeType``: 0 is a kernel), read through the CUDA runtime:
    every kernel, copy and fill the call puts on the stream."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL("libcudart.so.12")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    require(rt.cudaGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
            "cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    require(rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
            "cudaGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        types.append(kind.value)
    del graph
    return types


def assert_identical(got, want, what: str) -> float:
    """Every output equal (value, dtype, shape); returns the max abs error
    over the float outputs (0.0 when identical)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        require(a.dtype == b.dtype and a.shape == b.shape,
                f"{what}: output {i} is {a.dtype} {tuple(a.shape)}, plain "
                f"{b.dtype} {tuple(b.shape)}")
        if a.dtype.is_floating_point:
            fin = torch.isfinite(b)
            same_inf = torch.equal(torch.isfinite(a), fin) and torch.equal(
                a[~fin], b[~fin])
            require(same_inf, f"{what}: output {i} differs in its infinities")
            if fin.any():
                err = max(err, float((a[fin] - b[fin]).abs().max()))
        if not torch.equal(a, b):
            bad = (a != b).nonzero()[:3].tolist()
            raise AssertionError(f"{what}: output {i} differs at {bad}")
    return err


def bound_ms(bytes_moved: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bytes(b: int, cap: int, n: int) -> tuple[float, float]:
    """Bytes and float32 operations of one sweep: each edge (row, col, val)
    read once, row_ptr and the state read once, the four winner arrays
    written once; three float operations per edge for its gain."""
    return (b * (12 * cap + 4 * (n + 2) + 16 * (n + 1) + 16 * n),
            3.0 * b * cap)


def loop_bytes(cap: int, n: int, iters) -> tuple[float, float]:
    """Bytes and float32 operations the AWAC loop must move and do for this
    run's data: per round run by an instance, its edges, row_ptr and state
    read once; the final state written once per instance."""
    rounds = float(sum(int(i) for i in iters))
    b = len(iters)
    read = rounds * (12 * cap + 4 * (n + 2) + 16 * (n + 1))
    return read + b * 16 * (n + 1), rounds * 3.0 * cap


def mcm_bytes(nnz: int, n: int, phases: int,
              layers: int) -> tuple[float, float]:
    """Bytes and operations MCM must move and do for this run's phases and
    layers, whatever the design: each phase's BFS touches every edge's
    column and value once (a push over the frontier columns' edges would
    too, once a phase); each layer reads and writes a frontier bitmap; the
    matching read and written once; one comparison an edge a phase."""
    words = -(-n // 32)
    return (8.0 * nnz * phases + 8.0 * words * layers + 16.0 * (n + 1),
            float(nnz) * phases)


def lookup_sectors(row, col, rp, mate_row, mate_col, n: int,
                   active=None) -> tuple[int, int]:
    """32-byte sectors that one sweep's completion lookups touch on this
    state, as the kernels read them, and as a lookup through row_ptr
    without the row records would: per edge (i, j) with m_j matched and
    i > m_j (the lanes in ``active`` only), the sector of row m_j's
    16-byte record (the sectors of row_ptr[m_j] and row_ptr[m_j + 1]
    without records); when bit m_i & 63 of the record's signature is set
    (always, without records), the sectors of row m_j's columns (all of
    them: a short row is read whole, a longer one touches fewer) and,
    when the completion edge exists, of its weight."""
    b, cap = row.shape
    r, c = row.long(), col.long()
    edge = (r >= 0) & (r < n) & (c >= 0) & (c < n)
    qr = torch.gather(mate_row, 1, c.clamp(0, n)).long()
    look = edge & (qr >= 0) & (qr < n) & (r > qr)
    if active is not None:
        look &= active[:, None]
    q = qr.clamp(0, max(n - 1, 0))
    lo = torch.gather(rp, 1, q).long()
    hi = torch.gather(rp, 1, q + 1).long()
    lane = torch.arange(b, device=row.device)[:, None]
    a_lo, a_hi = 4 * (lane * cap + lo), 4 * (lane * cap + hi)
    cols = torch.where(hi > lo, (a_hi - 1) // 32 - a_lo // 32 + 1, 0)
    a_ptr = 4 * (lane * (n + 2) + q)
    ptrs = (a_ptr + 4) // 32 - a_ptr // 32 + 1
    m_i = torch.gather(mate_col, 1, r.clamp(0, n)).long()
    # bit c & 63 of row r's signature, for every edge (r, c)
    bits = torch.zeros(b * (n + 1) * 64, dtype=torch.bool, device=row.device)
    bits[((lane * (n + 1) + r.clamp(0, n)) * 64 + (c & 63))[edge]] = True
    maybe = bits[(lane * (n + 1) + q) * 64 + (m_i & 63)]
    # the completion edge (m_j, m_i) exists: a lookup of its (row, col)
    # key among the lane's sorted edge keys
    span = (n + 1) * (n + 1)
    keys = (lane * span + r * (n + 1) + c).reshape(-1)
    want = (lane * span + qr.clamp(0, n) * (n + 1) + m_i).reshape(-1)
    at = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    found = (keys[at] == want).reshape(b, cap)
    read = cols + found.long()
    touched = torch.where(look, 1 + torch.where(maybe, read, 0), 0)
    unfiltered = torch.where(look, ptrs + read, 0)
    return int(touched.sum()), int(unfiltered.sum())


def sectors_text(sectors: tuple[int, int]) -> str:
    ms = [s * 32 / HBM_BYTES_PER_S * 1e3 for s in sectors]
    return (f"lookups {sectors[0]} sectors, {ms[0]:.4f} ms at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s ({sectors[1]} sectors, "
            f"{ms[1]:.4f} ms without the row records)")


def loop_lookup_sectors(args, mg, go, n: int, ws: int,
                        iters) -> tuple[int, int]:
    """``lookup_sectors`` over every round of the AWAC loop: the sweep of
    round r runs on the state after r rounds (the plain loop's), for the
    lanes that run it."""
    row, col, val, rp = args[:4]
    iters = torch.as_tensor(iters, device=row.device)
    total = (0, 0)
    for r in range(int(iters.max()) if iters.numel() else 0):
        st = args[4:8] if r == 0 else awac_persistent_plain(
            *args, mg, go, n=n, window_steps=ws, max_iter=r)[:4]
        s = lookup_sectors(row, col, rp, st[0], st[1], n,
                           active=go & (iters > r))
        total = (total[0] + s[0], total[1] + s[1])
    return total


def launch_split(fn, calls: int = 20) -> dict[str, float]:
    """Device ms per call of each kernel and memset that ``fn`` launches,
    from a ``torch.profiler`` trace of ``calls`` calls after a warm-up
    (empty when the profiler recorded no device activity)."""
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    out = {}
    for e in device_rows(prof):
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].strip() or name
        out[name] = out.get(name, 0.0) + dev_us(e) / 1e3 / calls
    return out


def split_text(split: dict[str, float]) -> str:
    if not split:
        return "device time not recorded by the profiler"
    return ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def same_results(a, b, what: str) -> None:
    for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
        require(torch.equal(getattr(a, k), getattr(b, k)),
                f"{what}: {k} differs")
    require(torch.allclose(a.weight, b.weight, rtol=1e-6, atol=0),
            f"{what}: weight differs beyond rtol 1e-6")


def mcm_counted(row, col, val, n, st):
    """``single.mcm``'s plain version from a greedy state, phase by phase,
    counting phases and BFS layers and timing the BFS apart from the
    trace/flip."""
    mr, mc = st.mate_row, st.mate_col
    out = dict(phases=0, layers=0, bfs_s=0.0, flip_s=0.0)
    go = True
    while go and bool((mr[:n] == n).any()):
        (pc, vis, go, layers), dt = wall(
            lambda: single._mcm_bfs(row, col, val, n, mr, mc))
        out["bfs_s"] += dt
        (mr, mc), dt = wall(lambda: single.trace_and_flip(
            pc, vis, go, layers, mr, mc, n))
        out["flip_s"] += dt
        out["phases"] += 1
        out["layers"] += layers
    return single.state_from_mates(row, col, val, n, mr, mc), out


def profiled(fn, label: str, watch: tuple[str, ...] = ()) -> dict:
    """Device busy share over one call of ``fn`` and the kernels that take
    its device time, from ``torch.profiler``; for each name in ``watch``,
    also the device time and launches of the kernels whose name holds
    it."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    # the rows of device kernels only: an operator's row repeats the
    # device time of the kernels it launched
    rows = device_rows(prof)
    busy_us = sum(dev_us(e) for e in rows)
    require(busy_us > 0, f"[profile] {label}: no device time recorded")
    top = sorted(rows, key=dev_us, reverse=True)[:12]
    print(f"[profile] {label} under the profiler: {t:.3f} s wall, device "
          f"busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / t:.1f}%), "
          f"{sum(e.count for e in rows)} kernel launches")
    for e in top:
        print(f"[profile]   {dev_us(e) / 1e3:10.3f} ms  {e.count:7d} x  "
              f"{e.key[:90]}")
    out = dict(wall_s=t, device_busy_s=busy_us / 1e6, top=[
        dict(name=e.key, device_ms=dev_us(e) / 1e3, count=e.count)
        for e in top])
    out["watch"] = {}
    for name in watch:
        hit = [e for e in rows if name in e.key]
        w = out["watch"][name] = dict(count=sum(e.count for e in hit),
                                      device_ms=sum(dev_us(e) for e in hit)
                                      / 1e3)
        print(f"[profile]   {name}: {w['device_ms']:.3f} ms over "
              f"{w['count']} launches "
              f"({100 * w['device_ms'] / 1e3 / out['device_busy_s']:.2f}% "
              f"of the device time)")
    return out


def phase_profile(log, p):
    """One ``solve()`` under the profiler."""
    log["profile"] = profiled(lambda: solve(p), "solve()")


def phase_build(log):
    t0 = time.perf_counter()
    backend.library()
    info = dict(backend.BUILD_INFO)
    log["build_s"] = time.perf_counter() - t0
    regs = [ln.strip() for ln in info.get("ptxas", "").splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "wgmma", "arning"))]
    print(f"[build] {log['build_s']:.1f} s, cached={info.get('cached')}: "
          f"{info.get('library')}")
    for ln in regs:
        print(f"[build] ptxas: {ln}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    log["card"] = card


def single_graph():
    """The phase-2 instance (``SINGLE``)."""
    cfg = SINGLE
    return graph.generate(cfg["n"], avg_degree=cfg["avg_degree"],
                          kind=cfg["kind"], seed=cfg["seed"])


def batch_graphs():
    """The phase-3 batch (``BATCH``): kinds cycling through SUITE_KINDS."""
    cfg = BATCH
    kinds = graph.SUITE_KINDS
    return [graph.generate(cfg["n"], avg_degree=cfg["avg_degree"],
                           kind=kinds[i % len(kinds)], seed=i)
            for i in range(cfg["b"])]


def single_inputs(row, col, val, n, st):
    """The AWAC kernels' inputs for one instance [cap] at state ``st``:
    ((row, col, val, row_ptr, mate_row, mate_col, u, v) as [1, ...],
    window_steps)."""
    rp = row_ptr_from_sorted(row, n)[None]
    ws = single._resolve_window_steps(row, n, None)
    return (row[None], col[None], val[None], rp, *(x[None] for x in st)), ws


def batch_inputs(row, col, val, n):
    """The AWAC kernels' inputs for [B, cap] instances at their MCM state:
    ((row, col, val, row_ptr, mate_row, mate_col, u, v), window_steps)."""
    mr, mc = batch.greedy_maximal_batched(row, col, val, n)
    mr, mc = batch.mcm_batched(row, col, val, n, mr, mc)
    rp = batched_row_ptr_from_sorted(row, n)
    ws = single._resolve_window_steps(row, n, None)
    st = batch._state_from_mates_windowed(row, col, val, rp, n, mr, mc, ws)
    return (row, col, val, rp, *st), ws


def sweep_calls(args, mg, n, ws, scratch=None):
    """K1 on ``args`` as the engines call it: (a later round's call, whose
    scratch an earlier call on the same edges built; a loop's first call,
    which builds its row records). One call here on ``scratch`` (a new one
    by default) builds it or, when an earlier call on these edges did,
    keeps it, before either is timed."""
    if scratch is None:
        from repro_torch.kernels.cycle_gain.awac_sweep import SweepScratch
        scratch = SweepScratch()
    awac_sweep_batched(*args, mg, n=n, window_steps=ws, scratch=scratch)

    def later():
        return awac_sweep_batched(*args, mg, n=n, window_steps=ws,
                                  scratch=scratch)

    def first():
        return awac_sweep_batched(*args, mg, n=n, window_steps=ws)

    return later, first


def phase_single(log, kernels):
    cfg = SINGLE
    n = cfg["n"]
    t0 = time.perf_counter()
    g = single_graph()
    gen_s = time.perf_counter() - t0
    p = MatchingProblem.from_graph(g)
    print(f"[single] n={n} nnz={g.nnz} cap={g.capacity} kind={cfg['kind']} "
          f"generated in {gen_s:.1f} s")

    # the main path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    r_auto, t_auto = wall(lambda: solve(p))
    k_auto = backend.launch_counts()
    require(r_auto.execution.backend == auto_backend(n),
            f"auto resolved to {r_auto.execution.backend}")
    auto_launches(r_auto.execution, k_auto, int(r_auto.awac_iters),
                  "[single] auto", single_route=True)
    backend.reset_launch_counts()
    r_cuda, t_cuda = wall(lambda: solve(p, SolveOptions(backend="cuda")))
    k_cuda = backend.launch_counts()
    require(k_cuda["awac_sweep"] >= 1,
            f"the sweep kernel was not launched: {k_cuda}")
    require(k_cuda["mcm_persistent"] == 1,
            f"cuda: the MCM kernel was launched "
            f"{k_cuda['mcm_persistent']} times, not once")
    require(k_cuda["awac_sweep"] == int(r_cuda.awac_iters),
            f"sweep launches {k_cuda} != rounds {int(r_cuda.awac_iters)}")
    r_torch, t_torch = wall(lambda: solve(p, SolveOptions(backend="torch")))
    same_results(r_cuda, r_auto, "single: cuda vs auto")
    same_results(r_torch, r_auto, "single: torch vs auto")
    require(bool(r_auto.perfect), "single: the matching is not perfect")
    kernels["awac_persistent"]["launches"] = k_auto["awac_persistent"]
    kernels["awac_sweep"]["launches"] = k_cuda["awac_sweep"] \
        + k_auto["awac_sweep"]
    kernels["mcm_persistent"]["launches"] = k_cuda["mcm_persistent"] \
        + k_auto["mcm_persistent"]
    iters = int(r_auto.awac_iters)
    print(f"[single] solve(): auto {t_auto:.2f} s, cuda {t_cuda:.2f} s, "
          f"torch {t_torch:.2f} s; {iters} AWAC rounds, weight "
          f"{float(r_auto.weight)!r}; launches auto {k_auto}, cuda {k_cuda}")

    # the phase split, engine by engine; MCM as solve() runs it, in its
    # kernel, and its plain version phase by phase
    row, col, val = p.row, p.col, p.val
    rp = row_ptr_from_sorted(row, n)
    st0, t_greedy = wall(lambda: single.greedy_maximal(row, col, val, n))
    st, t_mcm = wall(lambda: single.mcm(row, col, val, n, st0.mate_row,
                                        st0.mate_col, row_ptr=rp))
    (st_plain, mcm_log), t_mcm_plain = wall(
        lambda: mcm_counted(row, col, val, n, st0))
    for field in ("mate_row", "mate_col", "u", "v"):
        require(torch.equal(getattr(st, field), getattr(st_plain, field)),
                f"single: MCM's {field} differs between its kernel and its "
                f"plain version")
    t_awac = {}
    for b in ("cuda_persistent", "cuda", "torch"):
        (s, it), t_awac[b] = wall(lambda: single.awac(row, col, val, n, st,
                                                      backend=b))
        require(int(it) == iters and torch.equal(s.mate_row, r_auto.mate_row),
                f"single: awac({b}) from the MCM state differs from solve()")
        final = s
    t_pre = t_auto - t_greedy - t_mcm - t_awac["cuda_persistent"]
    print(f"[single] MCM: {mcm_log['phases']} phases, {mcm_log['layers']} BFS "
          f"layers; kernel {t_mcm:.3f} s; plain {t_mcm_plain:.3f} s: BFS "
          f"{mcm_log['bfs_s']:.3f} s, trace/flip {mcm_log['flip_s']:.3f} s")
    print(f"[single] split: greedy {t_greedy:.3f} s, MCM {t_mcm:.3f} s, "
          f"AWAC cuda_persistent {t_awac['cuda_persistent']:.3f} s / cuda "
          f"{t_awac['cuda']:.3f} s / torch {t_awac['torch']:.3f} s; the rest "
          f"of solve() (preflight on the host, setup) {t_pre:.3f} s")
    log["single"] = dict(n=n, nnz=g.nnz, cap=g.capacity, iters=iters,
                         solve_s=dict(auto=t_auto, cuda=t_cuda,
                                      torch=t_torch),
                         greedy_s=t_greedy, mcm_s=t_mcm,
                         mcm_plain_s=t_mcm_plain, mcm=mcm_log,
                         awac_s=t_awac,
                         rest_s=t_pre)
    phase_mcm_kernel(log, kernels, row, col, val, rp, st0, g.nnz, n)

    # the persistent kernel against its plain version, from the MCM state
    args, ws = single_inputs(row, col, val, n, st)
    mg = torch.tensor(MIN_GAIN, dtype=torch.float32, device=row.device)
    go = torch.ones(1, dtype=torch.bool, device=row.device)
    got = awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                  max_iter=1000)
    sync()
    want = awac_persistent_plain(*args, mg, go, n=n, window_steps=ws,
                                 max_iter=1000)
    err = assert_identical(got, want, "single: persistent kernel vs plain")
    k2 = kernels["awac_persistent"]
    k2["max_abs_err"] = err
    k2["ms"] = event_ms(lambda: awac_persistent_batched(
        *args, mg, go, n=n, window_steps=ws, max_iter=1000), 5)
    k2["plain_ms"] = event_ms(lambda: awac_persistent_plain(
        *args, mg, go, n=n, window_steps=ws, max_iter=1000), 3)
    k2["bound_ms"], k2["bound_by"] = bound_ms(*loop_bytes(g.capacity, n,
                                                          [iters]))
    one_ms = event_ms(lambda: awac_persistent_batched(
        *args, mg, go, n=n, window_steps=ws, max_iter=1), 5)
    split = launch_split(lambda: awac_persistent_batched(
        *args, mg, go, n=n, window_steps=ws, max_iter=1000))
    sectors = loop_lookup_sectors(args, mg, go, n, ws, [iters])
    print(f"[single] persistent kernel {k2['ms']:.3f} ms ({one_ms:.3f} ms "
          f"at max_iter=1), plain {k2['plain_ms']:.3f} ms, bound "
          f"{k2['bound_ms']:.3f} ms ({k2['bound_by']}), {iters} rounds; "
          f"device: {split_text(split)}; {sectors_text(sectors)}")
    log["single"].update(loop_ms=k2["ms"], loop_one_round_ms=one_ms,
                         loop_device=split, loop_lookup_sectors=sectors)
    return p, st, args, ws, mg, iters, r_auto, final


def phase_mcm_kernel(log, kernels, row, col, val, rp, st0, nnz, n):
    """The MCM kernel against its plain version (``single.mcm_plain``) at
    the main path's shapes, from the greedy state ``st0``: mates bit for
    bit, its stats the plain loop's phases, layers and free word; both
    timed with CUDA events, the bound from this run's phases and
    layers."""
    mr0, mc0 = st0.mate_row, st0.mate_col
    got = mcm_persistent(row, col, val, rp, mr0, mc0, n=n)
    sync()
    want = single.mcm_plain(row, col, val, n, mr0, mc0)
    err = assert_identical(got[:2], want[:2],
                           "single: MCM kernel vs plain")
    phases, layers, free = got[2].tolist()
    require([phases, layers, free] == [want[2], want[3], int(want[4])],
            f"single: MCM kernel stats {[phases, layers, free]}, plain "
            f"{list(want[2:4])} and free {bool(want[4])}")
    km = kernels["mcm_persistent"]
    km["max_abs_err"] = err
    km["ms"] = event_ms(lambda: mcm_persistent(row, col, val, rp, mr0, mc0,
                                               n=n), 5)
    km["plain_ms"] = event_ms(lambda: single.mcm_plain(row, col, val, n,
                                                       mr0, mc0), 3)
    km["bound_ms"], km["bound_by"] = bound_ms(*mcm_bytes(nnz, n, phases,
                                                         layers))
    print(f"[single] MCM kernel {km['ms']:.3f} ms (median of 5), plain "
          f"{km['plain_ms']:.3f} ms (median of 3), bound "
          f"{km['bound_ms']:.3f} ms ({km['bound_by']}); {phases} phases, "
          f"{layers} BFS layers; mates and stats == plain")
    log["single"].update(mcm_kernel_ms=km["ms"],
                         mcm_plain_ms=km["plain_ms"],
                         mcm_bound_ms=km["bound_ms"], mcm_phases=phases,
                         mcm_layers=layers)


def phase_batch(log, kernels):
    cfg = BATCH
    n = cfg["n"]
    gs = batch_graphs()
    pb = MatchingProblem.stack(gs)
    backend.reset_launch_counts()
    rb, t_b = wall(lambda: solve(pb))
    k_b = backend.launch_counts()
    require(rb.execution.backend == auto_backend(n, cfg["b"]),
            f"batch: auto resolved to {rb.execution.backend}")
    auto_launches(rb.execution, k_b, int(rb.awac_iters.max()),
                  "[batch] auto")
    rt, t_t = wall(lambda: solve(pb, SolveOptions(backend="torch")))
    same_results(rt, rb, "batch: torch vs auto")
    for i, g in enumerate(gs):
        r1 = solve(MatchingProblem.from_graph(g))
        for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
            require(torch.equal(getattr(r1, k), getattr(rb, k)[i]),
                    f"batch lane {i}: {k} differs from its single solve")
    # the persistent kernel against its plain version, from the MCM state
    row, col, val = pb.row, pb.col, pb.val
    args, ws = batch_inputs(row, col, val, n)
    rp, st = args[3], args[4:]
    mg = torch.tensor(MIN_GAIN, dtype=torch.float32, device=row.device)
    go = torch.ones(cfg["b"], dtype=torch.bool, device=row.device)
    go[3] = False  # one lane gated off, as degrade_infeasible does
    got = awac_persistent_batched(row, col, val, rp, *st, mg, go, n=n,
                                  window_steps=ws, max_iter=1000)
    sync()
    want = awac_persistent_plain(row, col, val, rp, *st, mg, go, n=n,
                                 window_steps=ws, max_iter=1000)
    err2 = assert_identical(got, want, "batch: persistent kernel vs plain")
    iters = rb.awac_iters.tolist()
    print(f"[batch] B={cfg['b']} n={n}: solve() auto {t_b:.2f} s, torch "
          f"{t_t:.2f} s; rounds {iters}; every lane equals its single "
          f"solve; persistent kernel == plain (lane 3 gated off)")
    log["batch"] = dict(b=cfg["b"], n=n, cap=pb.cap, iters=iters,
                        solve_s=dict(auto=t_b, torch=t_t),
                        loaded=phase_batch_kernels(kernels, row, col, val, rp,
                                                   st, mg, n, ws, iters))
    k2 = kernels["awac_persistent"]
    k2["max_abs_err"] = max(k2["max_abs_err"], err2)
    return pb, rb


def phase_batch_kernels(kernels, row, col, val, rp, st, mg, n, ws, iters):
    """Both kernels against their plain versions, and timed, on the batch's
    MCM state: every lane has candidates there and runs 1 to 4 rounds, so
    the atomics and Step D carry real work."""
    b, cap = row.shape
    args = (row, col, val, rp, *st)
    go = torch.ones(b, dtype=torch.bool, device=row.device)

    k1, k1_first = sweep_calls(args, mg, n, ws)

    def p1():
        return awac_sweep_plain(*args, mg, n=n, window_steps=ws)

    def k2():
        return awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                       max_iter=1000)

    def p2():
        return awac_persistent_plain(*args, mg, go, n=n, window_steps=ws,
                                     max_iter=1000)

    want1 = p1()
    got1 = k1_first()
    sync()
    err1 = assert_identical(got1, want1, "batch: sweep kernel vs plain")
    got1 = k1()
    sync()
    err1 = max(err1, assert_identical(got1, want1, "batch: sweep kernel "
                                      "on a kept scratch vs plain"))
    rooted = int(torch.isfinite(got1[0]).sum())
    require(rooted > 0, "batch: the MCM state has no candidate")
    got2 = k2()
    sync()
    err2 = assert_identical(got2, p2(), "batch: persistent kernel vs plain "
                            "(every lane)")
    loop_iters = got2[4].tolist()
    require(loop_iters == iters,
            f"batch: kernel rounds {loop_iters} != solve() rounds {iters}")
    for name, err in (("awac_sweep", err1), ("awac_persistent", err2)):
        kv = kernels[name]
        kv["max_abs_err"] = max(kv.get("max_abs_err", 0.0), err)
    out = dict(rooted=rooted, sweep_ms=event_ms(k1, 21),
               sweep_first_ms=event_ms(k1_first, 21),
               sweep_host_ms=host_ms(k1),
               sweep_plain_ms=event_ms(p1, 5), loop_ms=event_ms(k2, 5),
               loop_plain_ms=event_ms(p2, 3), rounds=loop_iters,
               sweep_device_ms=graph_ms(k1), sweep_split=launch_split(k1),
               sweep_first_split=launch_split(k1_first),
               loop_one_round_ms=event_ms(lambda: awac_persistent_batched(
                   *args, mg, go, n=n, window_steps=ws, max_iter=1), 5),
               loop_device=launch_split(k2),
               sweep_lookup_sectors=lookup_sectors(row, col, rp, st[0],
                                                   st[1], n),
               loop_lookup_sectors=loop_lookup_sectors(args, mg, go, n, ws,
                                                       loop_iters))
    out["sweep_bound_ms"], out["sweep_bound_by"] = bound_ms(
        *sweep_bytes(b, cap, n))
    out["loop_bound_ms"], out["loop_bound_by"] = bound_ms(
        *loop_bytes(cap, n, loop_iters))
    print(f"[batch] MCM state: {rooted} rooted columns over {b} lanes; sweep "
          f"kernel {out['sweep_ms']:.3f} ms (median of 21; a loop's first "
          f"call, which builds the row records, {out['sweep_first_ms']:.3f} "
          f"ms), plain "
          f"{out['sweep_plain_ms']:.3f} ms (median of 5), bound "
          f"{out['sweep_bound_ms']:.4f} ms ({out['sweep_bound_by']}); "
          f"persistent kernel {out['loop_ms']:.3f} ms (median of 5), plain "
          f"{out['loop_plain_ms']:.3f} ms (median of 3), bound "
          f"{out['loop_bound_ms']:.4f} ms ({out['loop_bound_by']}), "
          f"{sum(loop_iters)} lane-rounds; both kernels == plain")
    print(f"[batch] sweep kernel: device {out['sweep_device_ms']:.4f} ms (a "
          f"CUDA graph of 20 calls), host {out['sweep_host_ms']:.4f} ms "
          f"(median of 21); by launch: "
          f"{split_text(out['sweep_split'])} (a first call: "
          f"{split_text(out['sweep_first_split'])}); "
          f"{sectors_text(out['sweep_lookup_sectors'])}")
    print(f"[batch] persistent kernel: {out['loop_one_round_ms']:.3f} ms at "
          f"max_iter=1; device: {split_text(out['loop_device'])}; "
          f"{sectors_text(out['loop_lookup_sectors'])}")
    return out


def phase_grid(log, kernels, single_run, batch_run):
    """[grid] The distributed engine (``core.dist``) on the 1x1 grid of
    one NCCL rank, through ``solve()`` and ``plan()``: every collective
    runs with one peer. Each result must equal phase 2's or phase 3's
    local one, bit for bit."""
    p, n = single_run[0], single_run[0].n
    r_local, s_local = single_run[6], single_run[7]
    pb, rb = batch_run
    grid, t_init = wall(lambda: make_grid(1, 1))
    require(tdist.get_backend() == "nccl", f"grid on {tdist.get_backend()}")
    print(f"[grid] NCCL group of one rank up in {t_init:.2f} s: {grid}")

    # the main path: solve() on the grid, "auto" (must mean "fused") and
    # "cuda" (the sweep kernel once per round)
    backend.reset_launch_counts()
    r_auto, t_auto = wall(lambda: solve(p, SolveOptions(grid=grid)))
    k_auto = backend.launch_counts()
    require((r_auto.execution.backend, r_auto.execution.source)
            == ("fused", "grid-default"),
            f"grid auto resolved to {r_auto.execution}")
    backend.reset_launch_counts()
    r_cuda, t_cuda = wall(lambda: solve(p, SolveOptions(grid=grid,
                                                        backend="cuda")))
    k_cuda = backend.launch_counts()
    require(k_cuda["awac_sweep"] >= 1 and
            k_cuda["awac_sweep"] == int(r_cuda.awac_iters),
            f"grid cuda: sweep launches {k_cuda}, rounds "
            f"{int(r_cuda.awac_iters)}")
    require(r_cuda.execution.ran_kernel is True, "grid cuda ran no kernel")
    kernels["awac_sweep"]["launches"] += k_cuda["awac_sweep"]
    same_results(r_auto, r_local, "grid auto vs local")
    same_results(r_cuda, r_local, "grid cuda vs local")

    # the engine's own output: the full state against phase 2's, and the
    # split of its phases
    rows = tuple(x.cpu().numpy()[None] for x in (p.row, p.col, p.val))
    splits = {}
    for b in ("fused", "cuda"):
        drv = dist._DistBatchedAWPM(grid, n, backend=b,
                                    degrade_infeasible=True)
        (st, it, dropped), t = wall(lambda: drv.run(*rows))
        require(int(dropped) == 0, f"grid {b}: {int(dropped)} dropped")
        require(int(it[0]) == int(r_local.awac_iters),
                f"grid {b}: {int(it[0])} rounds")
        for name, a, want in zip(("mate_row", "mate_col", "u", "v"), st,
                                 s_local):
            require(torch.equal(a[0], want), f"grid {b}: {name} differs")
        splits[b] = dict(drv.split, run_s=t)
    sp = splits["fused"]
    print(f"[grid] n={n}: solve() on the grid auto (fused) {t_auto:.2f} s, "
          f"cuda {t_cuda:.2f} s; the local solve() auto "
          f"{log['single']['solve_s']['auto']:.2f} s, cuda "
          f"{log['single']['solve_s']['cuda']:.2f} s; states and rounds "
          f"identical; sweep launches {k_cuda['awac_sweep']}")
    print(f"[grid] partition on the host {sp['partition_s']:.3f} s; split "
          f"(the engine alone, {sp['run_s']:.3f} s): greedy "
          f"{sp['greedy_s']:.3f} s, MCM {sp['mcm_s']:.3f} s, AWAC fused "
          f"{sp['awac_s']:.3f} s / cuda {splits['cuda']['awac_s']:.3f} s; "
          f"local: greedy {log['single']['greedy_s']:.3f} s, MCM "
          f"{log['single']['mcm_s']:.3f} s")

    prof = profiled(lambda: solve(p, SolveOptions(grid=grid)),
                    "solve() on the grid", watch=("scatter", "nccl"))

    # plan() once, two calls; the audited exchange
    matcher, t_plan = wall(lambda: plan(p, SolveOptions(grid=grid)))
    r1, t1 = wall(lambda: matcher(p))
    r2, t2 = wall(lambda: matcher(p))
    same_results(r1, r_local, "grid Matcher vs local")
    same_results(r2, r1, "grid Matcher, second call")
    r_chk, t_chk = wall(lambda: solve(p, SolveOptions(grid=grid,
                                                      exchange_check=True)))
    same_results(r_chk, r_local, "grid exchange_check vs local")
    print(f"[grid] plan() {t_plan:.3f} s, then two calls {t1:.2f} s / "
          f"{t2:.2f} s (block_cap {matcher.block_cap}); exchange_check "
          f"{t_chk:.2f} s; all identical")

    # phase 3's batch on the grid
    rg, t_b = wall(lambda: solve(pb, SolveOptions(grid=grid)))
    same_results(rg, rb, "grid batch vs local batch")
    print(f"[grid] B={pb.batch_size} n={pb.n}: solve() on the grid "
          f"{t_b:.2f} s (local {log['batch']['solve_s']['auto']:.2f} s); "
          f"every lane identical")
    log["grid"] = dict(init_s=t_init, solve_s=dict(auto=t_auto, cuda=t_cuda),
                       launches=dict(auto=k_auto, cuda=k_cuda),
                       split=splits, profile=prof, plan_s=t_plan,
                       matcher_s=[t1, t2],
                       check_s=t_chk, batch_s=t_b)
    return grid


class RecordingService(MatchingService):
    """The service, keeping each dispatched request's class-embedded
    instance, seed and true n for the direct solves that check its
    responses."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dispatched = {}

    def _dispatch(self, flush):
        for r in flush.items:
            self.dispatched[r.request_id] = (r.problem, r.seed, r.n)
        super()._dispatch(flush)


def mcm_batched_counted(row, col, val, n, mr, mc):
    """``batch.mcm_loop`` over the full edge list, as ``mcm_batched`` runs
    it, counting its phases and its BFS layers (calls of the parent
    selection)."""
    layers = 0

    def parents(fr, vis):
        nonlocal layers
        layers += 1
        return batch.bfs_parents_full(row, col, val, n, fr, vis)

    mr, mc, phases = batch.mcm_loop(n, row.shape[0], mr, mc, parents)
    return mr, mc, phases, layers


def warm_split(problem, seed):
    """The warm engine's phases on one instance ([1, cap]) from ``seed``,
    each timed to a device sync: the repair, the MCM top-up (phases and
    BFS layers), the dual build and AWAC ("auto": the persistent kernel).
    Returns (the split, MatchState, AWAC rounds)."""
    n = problem.n
    row, col, val = (x[None] for x in (problem.row, problem.col,
                                       problem.val))
    out = {}
    ws = batch._resolve_window_steps_batched(row, n, None)
    rp = batched_row_ptr_from_sorted(row, n)
    mr, mc = batch._normalize_mates_batched(seed[0][None], seed[1][None], 1,
                                            n, row.device)
    (mr, mc), out["repair_s"] = wall(lambda: batch.repair_mates_batched(
        row, col, val, rp, n, mr, mc, ws))
    out["unmatched_after_repair"] = int((mr[:, :n] == n).sum())
    (mr, mc, out["mcm_phases"], out["mcm_layers"]), out["mcm_s"] = wall(
        lambda: mcm_batched_counted(row, col, val, n, mr, mc))
    st, out["duals_s"] = wall(lambda: batch._state_from_mates_windowed(
        row, col, val, rp, n, mr, mc, ws))
    (st, iters), out["awac_s"] = wall(lambda: batch.awac_batched(
        row, col, val, n, st, row_ptr=rp, window_steps=ws))
    return out, MatchState(*(x[0] for x in st)), int(iters[0])


def same_stripped(got, want, what: str) -> None:
    """Two stripped (numpy) results: mates, rounds and flags equal, weight
    within rtol 1e-6."""
    for k in ("mate_row", "mate_col", "awac_iters", "perfect"):
        require(np.array_equal(getattr(got, k), getattr(want, k)),
                f"{what}: {k} differs")
    require(np.allclose(got.weight, want.weight, rtol=1e-6, atol=0),
            f"{what}: weight differs beyond rtol 1e-6")


def stream_text(summary, stats) -> str:
    return (f"served {summary['served']} ({summary['served_warm']} warm / "
            f"{summary['served_cold']} cold, {summary['degraded']} degraded, "
            f"{summary['rejected']} rejected); on the stream's clock "
            f"(lanes never queue behind one another there) throughput "
            f"{summary['throughput_rps']:.1f} requests/s, latency p50 "
            f"{summary['p50_us']:.0f} us, p95 {summary['p95_us']:.0f} us, "
            f"p99 {summary['p99_us']:.0f} us; mean fill "
            f"{summary['mean_fill']:.2f}, mean solve "
            f"{summary['mean_solve_us']:.0f} us per batch; plan cache "
            f"{stats['plan_resident']} resident, {stats['plan_cache']['hits']} "
            f"hits / {stats['plan_cache']['misses']} misses; warm cache "
            f"{stats['warm_cache']['served']} seeds served, "
            f"{stats['warm_cache']['stale']} stale, "
            f"{stats['warm_cache']['absent']} absent")


def ill_system(n: int, seed: int):
    """A diagonally weak matrix whose heavy entries sit on a hidden
    permutation: pivot-free LU fails on it without a row permutation
    (the JAX suite's ``tests/test_pivot.py::_ill_system``)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.2)
    a[rng.permutation(n), np.arange(n)] = rng.uniform(5.0, 10.0, n) * \
        rng.choice([-1, 1], n)
    np.fill_diagonal(a, rng.uniform(0, 1e-8, n))
    return a, a @ np.ones(n)


def phase_serve(log, kernels, grid):
    """[serve] The matching service and the warm-start engine on the card
    (see the module docstring, 3c)."""
    card = log["card"]
    out = log["serve"] = {}

    # the stream, with warm start and without
    spec = StreamSpec(**SERVE_STREAM)
    for b in (1, SERVE_CONFIG["max_batch"]):
        expect_auto("cuda_persistent", "[serve] lanes", n=spec.n, batch=b)
    runs = {}
    for mode in ("warm", "cold"):
        svc = RecordingService(ServiceConfig(**SERVE_CONFIG,
                                             warm_start=mode == "warm"))
        backend.reset_launch_counts()
        summary, t = wall(lambda: run_stream(svc, spec))
        launches = backend.launch_counts()
        rs = summary["responses"]
        require(len(rs) == spec.requests and all(
            r.ok and r.result.perfect for r in rs),
            f"[serve] {mode}: a response is not ok or not perfect")
        stats = svc.stats()
        lane_solve = {(r.shard, r.dispatched_at, r.lane): r.solve_s
                      for r in rs}
        lanes = len(lane_solve)
        # what one card holds: the stream's clock lets lanes overlap, so
        # its throughput is about the offered rate; this is requests over
        # the lanes' solve time, run one after another as the service does
        busy_s = sum(lane_solve.values())
        require(launches["awac_persistent"] == lanes,
                f"[serve] {mode}: {launches['awac_persistent']} persistent "
                f"kernel launches for {lanes} lanes")
        classes = sorted({r.size_class for r in rs})
        print(f"[serve] {mode}: {stream_text(summary, stats)}; {t:.2f} s for "
              f"the stream; classes {classes}; {lanes} lanes, "
              f"{busy_s * 1e3 / lanes:.1f} ms of solve per lane, "
              f"{busy_s:.3f} s in all: {len(rs) / busy_s:.1f} requests per "
              f"second of solve; persistent kernel launches "
              f"{launches['awac_persistent']} ({card})")
        runs[mode] = svc, summary
        out[mode] = dict(wall_s=t, launches=launches, lanes=lanes,
                         busy_s=busy_s, busy_rps=len(rs) / busy_s,
                         classes=[dataclasses.astuple(c) for c in classes],
                         stats=stats, **{k: v for k, v in summary.items()
                                         if k != "responses"})
    svc, summary = runs["warm"]
    plain = summary
    require(summary["served_warm"] > spec.requests // 2,
            f"[serve] only {summary['served_warm']} of {spec.requests} "
            f"served warm")
    kernels["awac_persistent"]["launches"] += out["warm"]["launches"][
        "awac_persistent"]

    # every warm response against a direct warm solve of its instance
    warm = [r for r in summary["responses"] if r.served_warm]
    probs = [svc.dispatched[r.request_id] for r in warm]
    pb = MatchingProblem(*(torch.stack([getattr(p, k) for p, _, _ in probs])
                           .cuda() for k in ("row", "col", "val")),
                         n=probs[0][0].n)
    seeds = tuple(np.stack([s[i] for _, s, _ in probs]) for i in (0, 1))
    direct, t_direct = wall(lambda: solve(pb, warm_start=seeds))
    for i, (r, (_, _, n_true)) in enumerate(zip(warm, probs)):
        same_stripped(r.result, strip_instance(direct, i, n_true, pb.n),
                      f"[serve] warm response {r.request_id} vs a direct "
                      f"solve(warm_start=)")
    print(f"[serve] the {len(warm)} warm responses equal one direct "
          f"solve(warm_start=) of their class-embedded instances "
          f"({t_direct:.3f} s, B={len(warm)}; {card})")

    # phase 2's instance in its exact batch-1 class
    g = single_graph()
    n = g.n
    big = RecordingService(ServiceConfig(**SERVE_CONFIG))
    clock = iter(range(100))

    def serve(inst):
        big.submit("solver", inst, now=float(next(clock)))
        (resp,) = big.responses()
        require(resp.ok and resp.result.perfect,
                f"[serve] n={n}: not ok or not perfect")
        return resp

    r_cold, t_cold = wall(lambda: serve(g))
    require(r_cold.lane == "cold" and r_cold.size_class == SizeClass(
        n=n, cap=r_cold.size_class.cap, batch=1),
        f"[serve] n={n}: {r_cold.lane} lane, class {r_cold.size_class}")
    r_same, t_same = wall(lambda: serve(g))
    require(r_same.served_warm and int(r_same.result.awac_iters) == 1,
            f"[serve] n={n} repeat: warm {r_same.served_warm}, "
            f"{int(r_same.result.awac_iters)} rounds")
    for k in ("mate_row", "mate_col", "weight", "perfect"):
        require(np.array_equal(getattr(r_same.result, k),
                               getattr(r_cold.result, k)),
                f"[serve] n={n}: the unchanged repeat's {k} differs")
    gp = perturbed(g, np.random.default_rng(0), 0.02, 1.0)
    require(gp.nnz == g.nnz - 1, "the perturbed repeat dropped no edge")
    r_pert, t_pert = wall(lambda: serve(gp))
    require(r_pert.served_warm, "[serve] the perturbed repeat was cold")
    print(f"[serve] n={n} nnz={g.nnz} in class {r_cold.size_class}: solve_s "
          f"cold {r_cold.solve_s:.3f} s, unchanged repeat (warm, 1 round, "
          f"bit for bit) {r_same.solve_s:.3f} s, perturbed repeat (warm, "
          f"{int(r_pert.result.awac_iters)} rounds) {r_pert.solve_s:.3f} s; "
          f"with admission {t_cold:.2f} / {t_same:.2f} / {t_pert:.2f} s "
          f"({card})")

    # the warm split of the perturbed repeat, on its own
    prob, seed, _ = big.dispatched[r_pert.request_id]
    pc = MatchingProblem(prob.row.cuda(), prob.col.cuda(), prob.val.cuda(),
                         n=prob.n)
    split, st, iters = warm_split(pc, seed)
    require(iters == int(r_pert.result.awac_iters) and np.array_equal(
        st.mate_row.cpu().numpy(), r_pert.result.mate_row),
        "[serve] the warm split differs from the served result")
    print(f"[serve] warm split at n={n}: repair {split['repair_s']:.3f} s "
          f"({split['unmatched_after_repair']} columns unmatched), MCM top-up "
          f"{split['mcm_phases']} phases / {split['mcm_layers']} BFS layers "
          f"{split['mcm_s']:.3f} s, duals {split['duals_s']:.3f} s, AWAC "
          f"(persistent kernel) {split['awac_s']:.3f} s, {iters} rounds "
          f"({card})")
    box = []
    prof = profiled(lambda: box.append(serve(gp)),
                    f"[serve] a warm serve at n={n}",
                    watch=("awac_loop_kernel", "scatter"))
    k2 = prof["watch"]["awac_loop_kernel"]
    require(k2["count"] >= 1,
            "[serve] the profiled warm serve shows no persistent kernel")
    print(f"[serve] the profiled warm serve: {prof['wall_s']:.3f} s wall, "
          f"device busy {prof['device_busy_s']:.3f} s, the persistent "
          f"kernel {k2['device_ms']:.3f} ms over {k2['count']} launch(es) "
          f"({card})")
    require(np.array_equal(box[0].result.mate_row, r_pert.result.mate_row),
            "[serve] the profiled serve differs")

    # the sweep kernel on the warm path, and the 1x1 grid
    backend.reset_launch_counts()
    r_k1, t_k1 = wall(lambda: solve(pc, SolveOptions(backend="cuda"),
                                    warm_start=seed))
    k1 = backend.launch_counts()["awac_sweep"]
    require(k1 == int(r_k1.awac_iters) >= 1 and np.array_equal(
        r_k1.mate_row.cpu().numpy(), r_pert.result.mate_row),
        f"[serve] warm 'cuda': {k1} sweep launches, "
        f"{int(r_k1.awac_iters)} rounds")
    kernels["awac_sweep"]["launches"] += k1
    r_loc, t_loc = wall(lambda: solve(pc, warm_start=seed))
    r_grid, t_grid = wall(lambda: solve(pc, SolveOptions(grid=grid),
                                        warm_start=seed))
    require(r_grid.execution.warm_started, "[serve] grid: not warm started")
    same_results(r_grid, r_loc, "[serve] warm start on the grid vs local")
    same_results(r_k1, r_loc, "[serve] warm 'cuda' vs 'auto'")
    print(f"[serve] warm solve() of the perturbed repeat: auto {t_loc:.3f} "
          f"s, cuda {t_k1:.3f} s ({k1} sweep launches), on the 1x1 grid "
          f"{t_grid:.3f} s; all identical ({card})")

    # certificates
    resp = warm[0]
    cert, t_cert = wall(lambda: certify(svc.dispatched[resp.request_id][0],
                                        resp.result))
    require(cert.upper_bound >= cert.weight, "[serve] unsound certificate")
    g400 = graph.generate(400, avg_degree=6.0, kind="antigreedy", seed=0)
    p400 = MatchingProblem.from_graph(g400)
    r400 = solve(p400)
    cert400, t_cert400 = wall(lambda: certify(p400, r400))
    _, opt = ref.exact_mwpm(g400.to_dense().astype(np.float32),
                            g400.structure_dense())
    scale = max(1.0, abs(float(opt)))
    require(cert400.upper_bound >= float(opt) - 1e-6 * scale and
            cert400.weight <= cert400.upper_bound + 1e-6 * scale,
            f"[serve] n=400: bound {cert400.upper_bound} against the "
            f"optimum {opt}")
    print(f"[serve] certify: a served n={resp.size_class.n} response "
          f"{t_cert:.3f} s (weight {cert.weight!r}, bound "
          f"{cert.upper_bound!r}, ratio bound {cert.ratio_bound!r}, tight "
          f"{cert.tight}, {cert.rounds} rounds); n=400 {t_cert400:.3f} s "
          f"(bound {cert400.upper_bound!r} >= optimum {float(opt)!r}, ratio "
          f"bound {cert400.ratio_bound!r}) ({card})")

    # static pivoting, one batched solve for 8 matrices
    mats, bs = zip(*(ill_system(PIVOT["n"], s) for s in range(PIVOT["b"])))
    (perm, iters), t_perm = wall(lambda: pivot.batched_pivot_permutations(
        mats))
    (perm_cpu, iters_cpu), t_perm_cpu = wall(
        lambda: pivot.batched_pivot_permutations(mats, device="cpu"))
    require(np.array_equal(perm, perm_cpu) and np.array_equal(iters,
                                                              iters_cpu),
            "[serve] pivot permutations differ between the card and the CPU")
    (xs, _), t_lu = wall(lambda: pivot.static_pivot_solve_batched(mats, bs))
    ones = np.ones(PIVOT["n"])
    errs = [pivot.relative_error(x, ones) for x in xs]
    require(max(errs) <= PIVOT["tol"], f"[serve] pivoting errors {errs}")
    # beside them, the same solves after the exact maximum-product matching
    exact = []
    for a, b in zip(mats, bs):
        a_s, _, _ = pivot.equilibrate(a)
        struct = a_s != 0
        logw = np.where(struct, np.log(np.maximum(np.abs(a_s), 1e-30)),
                        0.0).astype(np.float32)
        mr, _ = ref.exact_mwpm(logw, struct)
        exact.append(pivot.relative_error(pivot.static_pivot_solve(a, b, mr),
                                          ones))
    print(f"[serve] static pivoting, B={PIVOT['b']} n={PIVOT['n']}: "
          f"permutations on the card {t_perm:.3f} s, on the CPU "
          f"{t_perm_cpu:.3f} s, identical; AWAC rounds {iters.tolist()}; "
          f"solves {t_lu:.2f} s; relative errors {[f'{e:.2e}' for e in errs]} "
          f"(max {max(errs):.3e}, bar {PIVOT['tol']}; after the exact "
          f"matching {[f'{e:.2e}' for e in exact]}) ({card})")
    out.update(direct_s=t_direct, big=dict(
        n=n, cls=dataclasses.astuple(r_cold.size_class),
        solve_s=dict(cold=r_cold.solve_s, same=r_same.solve_s,
                     perturbed=r_pert.solve_s),
        split=split, profile=prof, solve_cuda_s=t_k1, solve_auto_s=t_loc,
        grid_s=t_grid), certify_s=t_cert, certify_n400_s=t_cert400,
        pivot=dict(card_s=t_perm, cpu_s=t_perm_cpu, solve_s=t_lu,
                   errors=errs, exact_errors=exact))
    return plain


def launched(fn):
    """(result, seconds, launch counts) of ``fn()``: the counts set to 0
    just before it and read just after, the time ending in a sync."""
    backend.reset_launch_counts()
    out, t = wall(fn)
    return out, t, backend.launch_counts()


#: the launch counter of each kernel backend
KERNEL_OF = {"cuda_persistent": "awac_persistent", "cuda": "awac_sweep"}


def auto_backend(n=None, batch=None) -> str:
    """The backend "auto" resolves to on the card for a problem of ``n``
    vertices (``batch`` instances), which the committed dispatch table
    (``kernels/dispatch_table.json``) must give."""
    chosen, source = single.resolve_auto(CARD, n=n, batch=batch)
    require(source == "table", f"auto on the card for n={n} batch={batch} "
            f"is not in the dispatch table ({chosen}, {source})")
    return chosen


def auto_launches(ex, k, rounds: int, what: str,
                  single_route: bool = False) -> None:
    """The launches of one ``solve()`` that ran "auto", read against the
    backend the table resolved it to (``ex``, its ``ExecutionInfo``): the
    persistent kernel once (one launch runs the whole loop, of every
    lane), the sweep kernel once per AWAC round (``rounds``, the most any
    lane ran), no kernel for "torch" or "reference"; with a kernel
    backend, the MCM kernel once on the single-instance route
    (``single_route``: one launch runs every phase) and never on the
    batched one, whose MCM is ``batch.mcm_loop``."""
    require(ex.source == "table", f"{what}: auto resolved by {ex.source}")
    want = {"awac_persistent": 0, "awac_sweep": 0, "mcm_persistent": 0}
    if ex.backend in KERNEL_OF:
        want[KERNEL_OF[ex.backend]] = 1 if ex.backend == "cuda_persistent" \
            else rounds
        want["mcm_persistent"] = int(single_route)
    got = {name: k[name] for name in want}
    require(got == want, f"{what}: launches {got} for auto = {ex.backend} "
            f"over {rounds} round(s); want {want}")


def expect_auto(backend_name: str, what: str, n=None, batch=None) -> None:
    """A check written for "auto" resolving to ``backend_name`` (its
    launch counts, its rung's label): the table must say so."""
    got = auto_backend(n, batch)
    require(got == backend_name,
            f"{what}: the dispatch table resolves auto (n={n}, batch="
            f"{batch}) to {got}; this check counts {backend_name}'s launches")


def guard_text(rr) -> str:
    """The guard's split of one served request."""
    sp = rr.report.split
    solve_s = sum(a.wall_s for a in rr.report.attempts)
    return (f"solve {solve_s:.3f} s, verify {sp.get('verify_s', 0.0):.3f} s "
            f"(host copies {sp.get('host_copy_s', 0.0):.3f} s, "
            f"{sp.get('host_bytes', 0) / 1e6:.1f} MB), audit "
            f"{sp.get('audit_s', 0.0):.3f} s, certificate "
            f"{sp.get('certify_s', 0.0):.3f} s")


def served_first(rr, rung: str, what: str) -> None:
    """A clean case must be served by its first rung, not degraded."""
    require(rr.report.backend_used == rung and not rr.report.degraded
            and len(rr.report.attempts) == 1,
            f"{what}: {rr.report.summary()} (want {rung}, first try)")


def phase_resilient(log, kernels, grid, single_run, batch_run):
    """[resilient] The guard (``runtime.resilient``) on the card: the
    phase-2 instance and the phase-3 batch through ``resilient_solve``
    and ``ResilientMatcher``, clean (served by the first rung, never
    degraded), on the 1x1 grid, and with the kernel rungs failing."""
    card = log["card"]
    out = log["resilient"] = {}
    p, r_local = single_run[0], single_run[6]
    pb, rb = batch_run
    guard = ResilientOptions(verify_convergence=True)

    # the main path: "auto" starts the chain where the table puts the
    # single_large class (the guard resolves it with no instance in hand)
    first = auto_backend()
    rr, t, k = launched(lambda: resilient_solve(p, resilience=guard))
    served_first(rr, f"local {first}", "[resilient] clean")
    if first in KERNEL_OF:
        require(k[KERNEL_OF[first]] >= 1, f"[resilient] clean launches {k}")
    same_results(rr.result, r_local, "[resilient] clean vs solve()")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    fails, t_verify = wall(lambda: verify_result(p, rr.result))
    require(fails == (), f"[resilient] verify_result: {fails}")
    print(f"[resilient] n={p.n}: served by {rr.report.backend_used} in "
          f"{t:.2f} s ({guard_text(rr)}); verify_result alone "
          f"{t_verify:.3f} s; launches {k} ({card})")
    out["clean"] = dict(wall_s=t, split=rr.report.split,
                        solve_s=rr.report.attempts[0].wall_s,
                        verify_result_s=t_verify, launches=k)

    # the certificate, at the serve class's n (at n = 2^20 its descent
    # runs n rounds over 16.7M edges on the host: PERF.md, Open questions)
    g = graph.generate(SERVE_STREAM["n"], avg_degree=SERVE_STREAM[
        "avg_degree"], kind="antigreedy", seed=0)
    pc = MatchingProblem.from_graph(g)
    rc, t_c, k = launched(lambda: resilient_solve(
        pc, resilience=ResilientOptions(verify_convergence=True,
                                        certify=True)))
    served_first(rc, f"local {first}", "[resilient] certify")
    cert = rc.report.certificate
    require(cert is not None and cert.upper_bound >= cert.weight,
            "[resilient] the certificate is missing or unsound")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    print(f"[resilient] n={pc.n} with certify=True: {t_c:.2f} s "
          f"({guard_text(rc)}); bound {cert.upper_bound!r} over weight "
          f"{cert.weight!r}, {cert.rounds} rounds, tight {cert.tight} "
          f"({card})")
    out["certify"] = dict(n=pc.n, wall_s=t_c, split=rc.report.split,
                          rounds=cert.rounds, tight=cert.tight)

    # the grid rung, on the 1x1 NCCL grid
    rg, t_g, _ = launched(lambda: resilient_solve(
        p, SolveOptions(grid=grid), resilience=guard))
    served_first(rg, "grid 1x1 (fused)", "[resilient] grid")
    same_results(rg.result, r_local, "[resilient] grid vs solve()")

    # injected failures: the persistent kernel down, then both kernels
    expect_auto("cuda_persistent", "[resilient] injected failures")
    with failing_backend("cuda_persistent"):
        r1, t1, k = launched(lambda: resilient_solve(p, resilience=guard))
    require(r1.report.backend_used == "local cuda" and r1.report.degraded,
            f"[resilient] K2 down: {r1.report.summary()}")
    require(k["awac_sweep"] == int(r1.result.awac_iters) >= 1,
            f"[resilient] K2 down: sweep launches {k}")
    same_results(r1.result, r_local, "[resilient] local cuda vs solve()")
    kernels["awac_sweep"]["launches"] += k["awac_sweep"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    with failing_backend("cuda_persistent", "cuda"):
        r2, t2, k2 = launched(lambda: resilient_solve(p, resilience=guard))
    require(r2.report.backend_used == "local torch" and
            k2["awac_sweep"] == k2["awac_persistent"]
            == k2["mcm_persistent"] == 0,
            f"[resilient] both kernels down: {r2.report.summary()}, {k2}")
    same_results(r2.result, r_local, "[resilient] local torch vs solve()")
    print(f"[resilient] grid: {rg.report.summary()} in {t_g:.2f} s; K2 "
          f"failing: {r1.report.summary()} in {t1:.2f} s ({k['awac_sweep']} "
          f"sweep launches); K1 and K2 failing: {r2.report.summary()} in "
          f"{t2:.2f} s; all identical to solve() ({card})")

    # the batch through a ResilientMatcher, twice (the second call reuses
    # the planned matcher)
    m = ResilientMatcher(pb, resilience=guard)
    rm, t_m1, k = launched(lambda: m(pb))
    served_first(rm, f"local {first}", "[resilient] batch")
    same_results(rm.result, rb, "[resilient] batch vs solve()")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    rm2, t_m2, k2 = launched(lambda: m(pb))
    served_first(rm2, f"local {first}", "[resilient] batch again")
    require(k2["awac_persistent"] == 1 or first != "cuda_persistent",
            f"[resilient] batch again: launches {k2}")
    same_results(rm2.result, rb, "[resilient] batch again vs solve()")
    kernels["awac_persistent"]["launches"] += k2["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k2["mcm_persistent"]
    print(f"[resilient] B={pb.batch_size} n={pb.n} through a "
          f"ResilientMatcher: {t_m1:.2f} s then {t_m2:.2f} s "
          f"({guard_text(rm2)}); launches {k} then {k2} ({card})")
    out.update(grid_s=t_g, k2_down_s=t1, kernels_down_s=t2,
               batch_s=[t_m1, t_m2], batch_split=rm2.report.split)


def phase_chaos(log, kernels):
    """[chaos] The detect-vs-survive matrix (``runtime.chaos``) on the
    1x1 grid of the card; the matrix prints its records."""
    card = log["card"]
    records, t, k = launched(lambda: run_chaos_matrix(1, 1, n=48))
    assert_all_ok(records)
    cases = [(r["fault"], r["mode"]) for r in records]
    require(len(cases) == 28 and ("device_loss_partial", "survive")
            not in cases, f"[chaos] {len(cases)} cases")
    detail = {f"{r['fault']} {r['mode']}": r["detail"] for r in records}
    first = auto_backend()
    require(f"local {first}" in detail["drop@stage1 survive"],
            f"[chaos] {detail['drop@stage1 survive']}")
    require(k["awac_sweep"] >= 1 and k[KERNEL_OF.get(first,
                                                     "awac_sweep")] >= 1,
            f"[chaos] launches {k}: the detect case must run the sweep "
            f"kernel, the survive cases the persistent one")
    kernels["awac_sweep"]["launches"] += k["awac_sweep"]
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    print(f"[chaos] {len(records)} cases on the 1x1 grid, all ok, in "
          f"{t:.2f} s; launches {k}; JAX's 2x4 matrix has 29: the 1x1 grid "
          f"has no row to lose without the grid, so no device_loss_partial "
          f"({card})")
    log["chaos"] = dict(wall_s=t, launches=k, records=records)


def phase_serve_resilient(log, kernels, plain):
    """[serve] resilient: the 256-request stream again, through
    ``ServiceConfig(resilient=True)``; every response as the plain
    service's, served by the persistent kernel's rung."""
    card = log["card"]
    spec = StreamSpec(**SERVE_STREAM)
    expect_auto("cuda_persistent", "[serve] resilient")
    svc = MatchingService(ServiceConfig(**SERVE_CONFIG, resilient=True))
    summary, t, k = launched(lambda: run_stream(svc, spec))
    rs, ps = summary["responses"], plain["responses"]
    require(len(rs) == len(ps) == spec.requests, "[serve] resilient: count")
    for r, q in zip(rs, ps):
        require(r.resilience == "served by local cuda_persistent after 1 "
                "attempt(s)", f"[serve] resilient {r.request_id}: "
                f"{r.resilience}")
        for f in ("request_id", "key", "shard", "size_class", "ok", "error",
                  "served_warm", "lane", "batch_fill", "flush_reason",
                  "submitted_at", "dispatched_at"):
            require(getattr(r, f) == getattr(q, f),
                    f"[serve] resilient {r.request_id}: {f} differs")
        same_stripped(r.result, q.result,
                      f"[serve] resilient {r.request_id}")
    lanes = {}
    for name, resp in (("plain", ps), ("resilient", rs)):
        lanes[name] = {(r.shard, r.dispatched_at, r.lane): r.solve_s
                       for r in resp}
    n_lanes = len(lanes["plain"])
    require(k["awac_persistent"] == n_lanes,
            f"[serve] resilient: {k['awac_persistent']} persistent launches "
            f"for {n_lanes} lanes")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    per = {name: sum(v.values()) / n_lanes for name, v in lanes.items()}
    print(f"[serve] resilient: {len(rs)} responses equal the plain "
          f"service's, each served by local cuda_persistent at the first "
          f"try; {t:.2f} s for the stream; solve_s per lane "
          f"{per['resilient'] * 1e3:.2f} ms with the guard, "
          f"{per['plain'] * 1e3:.2f} ms without; persistent kernel launches "
          f"{k['awac_persistent']} ({card})")
    log["serve"]["resilient"] = dict(
        wall_s=t, launches=k, lanes=n_lanes,
        solve_ms_per_lane=dict(plain=per["plain"] * 1e3,
                               resilient=per["resilient"] * 1e3))


def phase_solver(log, kernels):
    """[solver] The static-pivoting solver (``repro_torch.solver``): the
    six fixtures and three planted systems under the four arms, the
    matching and the sweeps on the card; the two absolute claims; the
    same run on the CPU."""
    card = log["card"]
    for n in (8, SOLVER_SCALE["n"]):  # the fixtures' orders, and at scale
        expect_auto("cuda_persistent", "[solver] awpm rows", n=n)
    (rows, failures), t, k = launched(lambda: solver_experiments.run(
        log=lambda *a: None))
    require(failures == [], f"[solver] claims: {failures}")
    (cpu_rows, cpu_fail), t_cpu = wall(lambda: solver_experiments.run(
        device="cpu", log=lambda *a: None))
    require(cpu_fail == [], f"[solver] CPU claims: {cpu_fail}")
    for r, c in zip(rows, cpu_rows):
        require((r.case, r.arm, r.converged, r.sweeps) ==
                (c.case, c.arm, c.converged, c.sweeps),
                f"[solver] {r.case} {r.arm}: card {r} vs CPU {c}")
        if r.arm == "awpm":
            require(r.k2_launches >= 1, f"[solver] {r.case}: no K2 launch")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    contrast = solver_experiments.contrast_cases(rows)
    print(f"[solver] {len(rows)} (case, arm) rows in {t:.2f} s on the card "
          f"({t_cpu:.2f} s on the CPU); awpm converged to <= "
          f"{solver_experiments.MAX_RESIDUAL:g} on 9/9; unpivoted fails "
          f"where awpm converges on {contrast}; persistent kernel launches "
          f"{k['awac_persistent']} ({card})")
    for r in rows:
        print(f"[solver]   {r.case:<20} {r.arm:<9} n={r.n:<3} matching "
              f"{r.matching_s * 1e3:8.2f} ms, LU {r.lu_s * 1e3:7.2f} ms, "
              f"refine {r.refine_s * 1e3:8.2f} ms, {r.sweeps} sweeps, "
              f"residual {r.residual:.3e}, K2 {r.k2_launches}")
    log["solver"] = dict(wall_s=t, cpu_s=t_cpu, launches=k,
                         contrast=contrast,
                         rows=[dataclasses.asdict(r) for r in rows])
    log["solver"]["scale"] = solver_at_scale(card, kernels)


def solver_at_scale(card, kernels) -> dict:
    """The awpm arm on the planted ill-conditioned system at
    ``SOLVER_SCALE``'s order, with the device operations of one float32
    solve through its factors: the triangular sweeps are n sequential
    rows of about log2(n) elementwise launches each."""
    name, _, (row, col, val, n) = solver_experiments.planted_illcond(
        **SOLVER_SCALE)
    b = np.random.default_rng(7).standard_normal(n)
    rep, t, k = launched(lambda: solve_linear_system((row, col, val, n), b))
    worst = float(rep.residual.max())
    require(rep.ok and worst <= solver_experiments.MAX_RESIDUAL
            and k["awac_persistent"] >= 1,
            f"[solver] {name}: ok {rep.ok}, residual {worst}, launches {k}")
    kernels["awac_persistent"]["launches"] += k["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += k["mcm_persistent"]
    factor = sparse_lu(CsrMatrix.from_coo(*rep.pivot.scaled_coo(row, col,
                                                                 val), n))
    sb = rep.pivot.scale_rhs(b)
    _, t_once = wall(lambda: lu_solve_once(factor, sb))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lu_solve_once(factor, sb)
        sync()
    ops = device_rows(prof)
    n_ops = sum(e.count for e in ops)
    dev_s = sum(dev_us(e) for e in ops) / 1e6
    cpu, t_cpu = wall(lambda: solve_linear_system((row, col, val, n), b,
                                                  device="cpu"))
    require(cpu.ok and np.array_equal(cpu.pivot.row_perm, rep.pivot.row_perm),
            f"[solver] {name}: the CPU's pivots differ from the card's")
    sp = rep.split
    sweeps = int(np.max(rep.refinement.iterations))
    print(f"[solver] {name} n={n} awpm: matching {sp['matching_s']:.3f} s, "
          f"LU {sp['lu_s']:.3f} s, refine {sp['refine_s']:.3f} s, {sweeps} "
          f"sweeps, residual {worst:.3e}, K2 {k['awac_persistent']}; one "
          f"float32 solve through the factors {t_once:.3f} s with {n_ops} "
          f"device operations, {dev_s:.3f} s of device time (busy "
          f"{dev_s / t_once:.1%} of the untraced call) ({card}); on the "
          f"CPU {t_cpu:.3f} s (matching {cpu.split['matching_s']:.3f}, LU "
          f"{cpu.split['lu_s']:.3f}, refine {cpu.split['refine_s']:.3f} s)")
    return dict(n=n, wall_s=t, split=sp, sweeps=sweeps, residual=worst,
                launches=k, solve_once_s=t_once, device_ops=n_ops,
                device_s=dev_s, cpu_s=t_cpu, cpu_split=cpu.split)


def phase_sweep(log, kernels, single_run):
    """The sweep kernel on a state from the middle of the phase-2 AWAC run
    (the MCM state itself when the run has fewer than three rounds: its
    last round finds nothing, so only the rounds before it sweep real
    candidates)."""
    p, st, args, ws, mg, iters = single_run[:6]
    n = p.n
    rounds = (iters - 1) // 2
    margs = args
    if rounds > 0:
        go = torch.ones(1, dtype=torch.bool, device=p.device)
        mid = awac_persistent_batched(*args, mg, go, n=n, window_steps=ws,
                                      max_iter=rounds)
        margs = args[:4] + tuple(mid[:4])
    # one scratch over two rounds' states, as the engines keep it: built
    # on the MCM state, kept for the measured one
    from repro_torch.kernels.cycle_gain.awac_sweep import SweepScratch

    k1 = kernels["awac_sweep"]
    scratch = SweepScratch()
    if margs is not args:
        later, _ = sweep_calls(args, mg, n, ws, scratch)
        k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0), assert_identical(
            later(), awac_sweep_plain(*args, mg, n=n, window_steps=ws),
            "sweep kernel vs plain (MCM state)"))
    later, first = sweep_calls(margs, mg, n, ws, scratch)
    want = awac_sweep_plain(*margs, mg, n=n, window_steps=ws)
    for what, call in (("a first call", first), ("a kept scratch", later)):
        got = call()
        sync()
        k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0), assert_identical(
            got, want, f"sweep kernel vs plain ({what})"))
    rooted = int(torch.isfinite(got[0]).sum())
    require(rooted > 0, "the measured sweep has no candidate")
    k1["ms"] = event_ms(later, 21)
    first_ms = event_ms(first, 21)
    k1["plain_ms"] = event_ms(lambda: awac_sweep_plain(*margs, mg, n=n,
                                                       window_steps=ws), 5)
    k1["bound_ms"], k1["bound_by"] = bound_ms(*sweep_bytes(1, p.cap, n))
    device_ms, split = graph_ms(later), launch_split(later)
    host = host_ms(later)
    first_split = launch_split(first)
    sectors = lookup_sectors(margs[0], margs[1], margs[3], margs[4],
                             margs[5], n)
    print(f"[sweep] state after {rounds} of {iters} rounds: {rooted} rooted "
          f"columns; kernel {k1['ms']:.3f} ms (median of 21; a loop's first "
          f"call, which builds the row records, {first_ms:.3f} ms), plain "
          f"{k1['plain_ms']:.3f} ms (median of 5), bound "
          f"{k1['bound_ms']:.3f} ms ({k1['bound_by']})")
    print(f"[sweep] device {device_ms:.4f} ms (a CUDA graph of 20 calls), "
          f"host {host:.4f} ms (median of 21); by "
          f"launch: {split_text(split)} (a first call: "
          f"{split_text(first_split)}); {sectors_text(sectors)}")
    log["sweep"] = dict(after_rounds=rounds, rooted=rooted, ms=k1["ms"],
                        first_ms=first_ms, device_ms=device_ms, host_ms=host,
                        split=split,
                        first_split=first_split, lookup_sectors=sectors)


def phase_quality(log):
    g = graph.generate(400, avg_degree=6.0, kind="antigreedy", seed=0)
    r = solve(MatchingProblem.from_graph(g))
    dense = g.to_dense().astype(np.float32)
    struct = g.structure_dense()
    _, opt = ref.exact_mwpm(dense, struct)
    mr = r.mate_row[:g.n].cpu().numpy()
    ref.check_matching(struct, mr)
    ratio = float(r.weight) / opt
    require(bool(r.perfect) and ratio >= 2 / 3,
            f"n=400: perfect={bool(r.perfect)}, ratio {ratio}")
    print(f"[quality] n=400 antigreedy: perfect, {int(r.awac_iters)} rounds, "
          f"weight {float(r.weight)!r} / optimum {opt!r} = {ratio!r}")
    log["ratio_n400"] = ratio


def phase_lm(log, kernels):
    """LM serving on qwen2-0.5b at full width and depth, through the
    flash-attention kernel; the same prefill through the plain attention;
    the smoke-size model on the card against the CPU."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), attention_impl="cuda")
    dev = torch.device("cuda")
    b, plen, steps = LM["batch"], LM["prompt_len"], LM["decode_steps"]
    model, t_init = wall(lambda: build_defs(cfg, device=dev, seed=LM["seed"]))
    n_params = count_params(model)
    require(n_params == QWEN2_0_5B_PARAMS,
            f"qwen2-0.5b has {n_params} parameters, not {QWEN2_0_5B_PARAMS}")
    serve_lm(cfg, b, plen, 2, device=dev, model=model)  # warm-up: cuBLAS, allocator

    # the main path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    out = serve_lm(cfg, b, plen, steps, device=dev, model=model)
    counts = backend.launch_counts()
    require(counts["flash_attention"] > 0,
            f"[lm] the flash-attention kernel was not launched: {counts}")
    require(counts["flash_attention"] == cfg.n_layers,
            f"[lm] {counts['flash_attention']} kernel launches in one "
            f"prefill, not one per layer ({cfg.n_layers})")
    kernels["flash_attention"]["launches"] = counts["flash_attention"]
    ids = out.ids
    require(tuple(ids.shape) == (b, steps) and bool((ids >= 0).all())
            and bool((ids < cfg.vocab).all()), f"[lm] ids {tuple(ids.shape)}")
    require(bool(torch.isfinite(out.last_logits).all()),
            "[lm] non-finite logits")
    print(f"[lm] qwen2-0.5b ({n_params} parameters, float32 weights, bf16 "
          f"activations, drawn in {t_init:.2f} s): batch {b}, prompt {plen}, "
          f"{steps} decode steps; prefill {out.prefill_ms:.1f} ms, decode "
          f"{out.decode_ms:.2f} ms/token; {counts['flash_attention']} kernel "
          f"launches; first ids {ids[:, :8].tolist()}")

    # the same prefill through the plain attention
    tokens = prompt_tokens(cfg, b, plen, LM["seed"]).to(dev)
    plain_cfg = dataclasses.replace(cfg, attention_impl="torch")
    (plain_logits, _), t_plain = wall(lambda: T.prefill(model, tokens,
                                                        plain_cfg))
    (kern_logits, _), t_kern = wall(lambda: T.prefill(model, tokens, cfg))
    require(torch.equal(kern_logits, out.last_logits),
            "[lm] a second kernel prefill gave other logits")
    diff = float((kern_logits - plain_logits).abs().max())
    top = float(plain_logits.abs().max())
    agree = float((kern_logits.argmax(-1) == plain_logits.argmax(-1))
                  .float().mean())
    require(diff <= LM_LOGIT_TOL * top,
            f"[lm] kernel and plain prefill logits differ by {diff} "
            f"(largest |logit| {top}, tolerance {LM_LOGIT_TOL} of it)")
    # both bf16 paths against the same model in float32 (plain attention):
    # the kernel path must not stray further from it than the plain path,
    # up to a factor LM_F32_RATIO
    f32_logits, _ = T.prefill(model, tokens, dataclasses.replace(
        plain_cfg, dtype="float32"))
    err_kern = float((kern_logits - f32_logits).abs().max())
    err_plain = float((plain_logits - f32_logits).abs().max())
    require(err_kern <= LM_F32_RATIO * err_plain,
            f"[lm] against the float32 model the kernel path errs by "
            f"{err_kern}, the plain path by {err_plain}")
    print(f"[lm] prefill logits, kernel against plain attention: max abs "
          f"diff {diff!r} (largest |logit| {top!r}, tolerance "
          f"{LM_LOGIT_TOL * top!r}); against the float32 model: kernel "
          f"path {err_kern!r}, plain path {err_plain!r}; greedy first token "
          f"agrees on {agree * b:.0f} of {b} rows; prefill alone "
          f"{t_kern * 1e3:.1f} ms (kernel) / {t_plain * 1e3:.1f} ms (plain)")

    # where the time goes: one prefill, then four decode steps
    log["lm_profile_prefill"] = profiled(
        lambda: T.prefill(model, tokens, cfg), "[lm] prefill",
        watch=("flash_fwd",))
    cache = grow_cache(T.prefill(model, tokens, cfg)[1], cfg, plen + 4)
    tok = kern_logits.argmax(-1)[:, None]
    log["lm_profile_decode"] = profiled(
        lambda: [T.decode_step(model, cache, tok, plen + i, cfg)
                 for i in range(4)], "[lm] 4 decode steps")

    # the smoke-size model (float32) on the card against the CPU
    small = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                                attention_impl="cuda")
    m_cpu = build_defs(small, device="cpu", seed=0)
    r_gpu = serve_lm(small, 2, 128, 8, device=dev,
                     model=copy.deepcopy(m_cpu).to(dev))
    r_cpu = serve_lm(small, 2, 128, 8, device="cpu", model=m_cpu)
    small_diff = float((r_gpu.last_logits.cpu() - r_cpu.last_logits)
                       .abs().max())
    require(torch.equal(r_gpu.ids.cpu(), r_cpu.ids)
            and small_diff <= SMOKE_TOL,
            f"[lm] smoke model: card and CPU differ (ids equal: "
            f"{torch.equal(r_gpu.ids.cpu(), r_cpu.ids)}, logits {small_diff})")
    print(f"[lm] qwen2-0.5b-smoke float32: card == CPU ids, logits max abs "
          f"diff {small_diff!r}")
    log["lm"] = dict(params=n_params, batch=b, prompt_len=plen,
                     decode_steps=steps, prefill_ms=out.prefill_ms,
                     decode_ms_per_token=out.decode_ms,
                     prefill_kernel_ms=t_kern * 1e3,
                     prefill_plain_ms=t_plain * 1e3,
                     launches=counts["flash_attention"],
                     logits_max_abs_diff=diff, largest_logit=top,
                     f32_err_kernel=err_kern, f32_err_plain=err_plain,
                     first_token_agreement=agree, smoke_diff=small_diff,
                     first_ids=ids[:, :8].tolist())


def phase_dense_lm(log, kernels):
    """[dense_lm] qwen2-7b (all 28 layers) and qwen1.5-110b (6 of 80
    layers, full width) served in turn through ``serve_lm``, float32
    weights drawn from seed 0 on the card, bf16 activations; each model
    checked as ``phase_lm`` checks qwen2-0.5b, timed against its model
    FLOPs (``roofline.analysis.useful_flops``), profiled, and freed
    before the next is built."""
    card = log["card"]
    dev = CARD
    b, plen = DENSE_LM["batch"], DENSE_LM["prompt_len"]
    cell = ShapeSpec("prefill", "prefill",
                     (("seq_len", plen), ("global_batch", b)))
    out_log = log["dense_lm"] = {}
    for arch, layers, steps in DENSE_LM["models"]:
        cfg = dataclasses.replace(get_config(arch), attention_impl="cuda")
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        tag = f"[dense_lm] {arch}"
        free_card()
        torch.cuda.reset_peak_memory_stats()
        model, t_init = wall(lambda: build_defs(cfg, device=dev,
                                                seed=DENSE_LM["seed"]))
        n_params = count_params(model)
        require(n_params == DENSE_LM_PARAMS[arch],
                f"{tag} has {n_params} parameters, not "
                f"{DENSE_LM_PARAMS[arch]}")
        serve_lm(cfg, b, plen, 2, device=dev, model=model)  # warm-up

        # the main path, as a user calls it; the counts are read right after
        backend.reset_launch_counts()
        out = serve_lm(cfg, b, plen, steps, device=dev, model=model)
        counts = backend.launch_counts()
        require(counts["flash_attention"] == cfg.n_layers,
                f"{tag}: {counts['flash_attention']} K5 launches in one "
                f"serve, not one per layer of the prefill ({cfg.n_layers})")
        kernels["flash_attention"]["launches"] += counts["flash_attention"]
        ids = out.ids
        require(tuple(ids.shape) == (b, steps) and bool((ids >= 0).all())
                and bool((ids < cfg.vocab).all()),
                f"{tag}: ids {tuple(ids.shape)} outside the vocabulary")
        require(bool(torch.isfinite(out.last_logits).all()),
                f"{tag}: non-finite logits")
        peak = torch.cuda.max_memory_allocated() / 2**30

        # the prefill alone, through the kernel and the plain attention,
        # then the same model in float32 (plain attention)
        tokens = prompt_tokens(cfg, b, plen, DENSE_LM["seed"]).to(dev)
        plain_cfg = dataclasses.replace(cfg, attention_impl="torch")
        backend.reset_launch_counts()
        (kern, _), t_kern = wall(lambda: T.prefill(model, tokens, cfg))
        pf = backend.launch_counts()["flash_attention"]
        require(pf == cfg.n_layers, f"{tag}: one prefill launched K5 {pf} "
                f"times, not {cfg.n_layers}")
        require(torch.equal(kern, out.last_logits),
                f"{tag}: a second kernel prefill gave other logits")
        (plain, _), t_plain = wall(lambda: T.prefill(model, tokens,
                                                     plain_cfg))
        diff = float((kern - plain).abs().max())
        top = float(plain.abs().max())
        torch.cuda.reset_peak_memory_stats()
        (f32, _), t_f32 = wall(lambda: T.prefill(
            model, tokens, dataclasses.replace(plain_cfg, dtype="float32")))
        f32_peak = torch.cuda.max_memory_allocated() / 2**30
        err_kern = float((kern - f32).abs().max())
        err_plain = float((plain - f32).abs().max())
        agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        flops = useful_flops(arch, cell.name, "prefill", cfg, cell)
        share = flops / t_kern / BF16_OPS_PER_S
        print(f"{tag} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}; {n_params} "
              f"parameters, float32 weights drawn in {t_init:.2f} s): batch "
              f"{b}, prompt {plen}, {steps} decode steps; prefill "
              f"{out.prefill_ms:.1f} ms (serve_lm, with the cache grown), "
              f"decode {out.decode_ms:.2f} ms/token; peak {peak:.2f} GiB; K5 "
              f"launches {counts['flash_attention']}; first ids "
              f"{ids[:, :8].tolist()} ({card})")
        print(f"{tag} prefill alone {t_kern * 1e3:.1f} ms (kernel) / "
              f"{t_plain * 1e3:.1f} ms (plain) / {t_f32 * 1e3:.1f} ms "
              f"(float32, peak {f32_peak:.2f} GiB); model FLOPs "
              f"{flops:.4g} (useful_flops), {flops / t_kern / 1e12:.1f} "
              f"TFLOP/s, {100 * share:.1f}% of the bf16 peak ({card})")
        print(f"{tag} prefill logits, kernel against plain attention: max "
              f"abs diff {diff!r} (largest |logit| {top!r}, tolerance "
              f"{LM_LOGIT_TOL * top!r}); against the float32 model: kernel "
              f"path {err_kern!r}, plain path {err_plain!r}; greedy first "
              f"token agrees on {agree * b:.0f} of {b} rows")
        require(diff <= LM_LOGIT_TOL * top,
                f"{tag}: kernel and plain prefill logits differ by {diff} "
                f"(largest |logit| {top}, tolerance {LM_LOGIT_TOL} of it)")
        require(err_kern <= LM_F32_RATIO * err_plain,
                f"{tag}: against the float32 model the kernel path errs by "
                f"{err_kern}, the plain path by {err_plain}")
        del plain, f32

        # where the time goes: one prefill, then four decode steps
        # cuBLAS's Hopper GEMMs are the nvjet kernels; the bf16 copies are
        # the float32 weights cast at each use
        watch = ("flash_fwd", "nvjet", "bfloat16_copy")
        prof_pf = profiled(lambda: T.prefill(model, tokens, cfg),
                           f"{tag} prefill", watch=watch)
        cache = grow_cache(T.prefill(model, tokens, cfg)[1], cfg, plen + 4)
        tok = kern.argmax(-1)[:, None]
        prof_dec = profiled(
            lambda: [T.decode_step(model, cache, tok, plen + i, cfg)
                     for i in range(4)], f"{tag} 4 decode steps",
            watch=watch[1:])
        out_log[arch] = dict(
            layers=cfg.n_layers, params=n_params, batch=b, prompt_len=plen,
            decode_steps=steps, prefill_ms=out.prefill_ms,
            decode_ms_per_token=out.decode_ms, prefill_kernel_ms=t_kern * 1e3,
            prefill_plain_ms=t_plain * 1e3, prefill_f32_ms=t_f32 * 1e3,
            peak_gib=peak, f32_peak_gib=f32_peak,
            launches=counts["flash_attention"], model_flops=flops,
            bf16_peak_share=share, logits_max_abs_diff=diff,
            largest_logit=top, f32_err_kernel=err_kern,
            f32_err_plain=err_plain, first_token_agreement=agree,
            first_ids=ids[:, :8].tolist(), profile_prefill=prof_pf,
            profile_decode=prof_dec)
        del model, cache, out, kern, tokens
        free_card()

        # the smoke-size model (float32) on the card against the CPU
        small = dataclasses.replace(get_config(arch, reduced=True),
                                    attention_impl="cuda")
        m_cpu = build_defs(small, device="cpu", seed=0)
        r_gpu = serve_lm(small, 2, 128, 8, device=dev,
                         model=copy.deepcopy(m_cpu).to(dev))
        r_cpu = serve_lm(small, 2, 128, 8, device="cpu", model=m_cpu)
        small_diff = float((r_gpu.last_logits.cpu() - r_cpu.last_logits)
                           .abs().max())
        same_ids = torch.equal(r_gpu.ids.cpu(), r_cpu.ids)
        print(f"{tag}-smoke float32: card and CPU ids equal: {same_ids}; "
              f"logits max abs diff {small_diff!r}")
        require(same_ids and small_diff <= SMOKE_TOL,
                f"{tag} smoke model: card and CPU differ (ids equal: "
                f"{same_ids}, logits {small_diff})")
        out_log[arch]["smoke_diff"] = small_diff


def phase_flash(log, kernels):
    """K5 against its plain version: the bf16 tensor-core kernel on the
    prefill's shapes and around them (full, a ragged S, D = 16 and 32,
    Sk != S, the model layout's strided views), the float32 CUDA-core
    kernel on the prefill's shape; both timed there, the bf16 kernel also
    at qwen2-moe-a2.7b's head shape, beside its bound, its plain version
    and ``scaled_dot_product_attention``."""
    dev = torch.device("cuda")
    b, s = LM["batch"], LM["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # what, dtype, causal, S, Sk, D
        ("prefill", bf16, True, s, s, 64), ("prefill", f32, True, s, s, 64),
        ("full", bf16, False, s, s, 64), ("ragged", bf16, True, 1000, 1000, 64),
        ("D=16", bf16, True, s, s, 16), ("D=32", bf16, True, s, s, 32),
        ("Sk > S", bf16, True, 1000, s, 64), ("Sk < S", bf16, False, s, 1000, 64),
        ("model layout views", bf16, True, s, s, 64)]
    k5 = kernels["flash_attention"]
    k5["max_abs_err"] = 0.0
    rows = []
    for what, dtype, causal, sq, sk, d in cases:
        q = torch.randn((b, 14, sq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, 2, sk, d), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        if what == "model layout views":
            # q, k, v as the [B, S, heads, D] views of one fused projection,
            # through the model's entry: no copy, output [B, S, H, D]
            fused = torch.cat([x.transpose(1, 2) for x in (q, k, v)], dim=2)
            views = (fused[:, :, :14], fused[:, :, 14:16], fused[:, :, 16:])
            sync()
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            got = attention(*views, causal=causal, use_kernel=True)
            sync()
            require(torch.cuda.memory_stats()["allocation.all.allocated"]
                    == allocs + 1 and got.is_contiguous(),
                    "[flash] the model-layout entry copied an operand or "
                    "returned a non-contiguous output")
            nodes = graph_node_types(
                lambda: attention(*views, causal=causal, use_kernel=True))
            require(nodes == [0], f"[flash] the model-layout entry put "
                    f"{nodes} on the stream, not K5 alone")
            got = got.transpose(1, 2)
        else:
            got = flash_attention(q, k, v, causal=causal)
            sync()
        want = attention_plain(q, k, v, causal=causal)
        tol = FLASH_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        require(got.dtype == dtype and torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol),
            f"[flash] {what} {dtype} causal={causal} S={sq} Sk={sk} D={d}: "
            f"kernel differs from plain by {err}")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        rows.append(dict(case=what, dtype=str(dtype), causal=causal, s=sq,
                         sk=sk, d=d, err=err))
        print(f"[flash] {what}: [{b}, 14, {sq}, {d}] / [{b}, 2, {sk}, {d}] "
              f"{dtype} causal={causal}: kernel == plain within {tol} (max "
              f"abs err {err!r})")
    timed = {}
    # the head shapes of the served models, each held to the plain version
    heads = {"d128": "qwen2-moe-a2.7b heads", "qwen2-7b": "qwen2-7b heads",
             "qwen1.5-110b": "qwen1.5-110b heads"}
    for name, h, hkv, d, dtype in (("d64", 14, 2, 64, bf16),
                                   ("d128", 16, 16, 128, bf16),
                                   ("qwen2-7b", 28, 4, 128, bf16),
                                   ("qwen1.5-110b", 64, 8, 128, bf16),
                                   ("d64_f32", 14, 2, 64, f32)):
        q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        if name in heads:
            got = flash_attention(q, k, v, causal=True)
            sync()
            want = attention_plain(q, k, v, causal=True)
            err = float((got.float() - want.float()).abs().max())
            require(torch.allclose(got.float(), want.float(),
                                   rtol=FLASH_TOL[bf16], atol=FLASH_TOL[bf16]),
                    f"[flash] {heads[name]} [{b}, {h}, {s}, {d}] / [{b}, "
                    f"{hkv}, {s}, {d}]: kernel differs from plain by {err}")
            del got, want
            k5["max_abs_err"] = max(k5["max_abs_err"], err)
            rows.append(dict(case=heads[name], dtype=str(bf16), h=h, hkv=hkv,
                             causal=True, s=s, sk=s, d=d, err=err))
            print(f"[flash] {heads[name]}: [{b}, {h}, {s}, {d}] / [{b}, "
                  f"{hkv}, {s}, {d}] bf16 causal: kernel == plain within "
                  f"{FLASH_TOL[bf16]} (max abs err {err!r})")
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)

        t = dict(ms=event_ms(lambda: flash_attention(q, k, v, causal=True),
                             21),
                 plain_ms=event_ms(
                     lambda: attention_plain(q, k, v, causal=True), 5),
                 library_ms=event_ms(sdpa, 21),
                 device_ms=graph_ms(
                     lambda: flash_attention(q, k, v, causal=True)),
                 library_device_ms=graph_ms(sdpa))
        t["bound_ms"], t["bound_by"] = bound_ms(
            *attention_work(b, h, hkv, s, s, d, True, q.element_size()),
            BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S)
        ops = attention_work(b, h, hkv, s, s, d, True, 2)[1]
        t["tflops"] = ops / t["ms"] / 1e9
        timed[name] = t
        print(f"[flash] [{b}, {h}, {s}, {d}] / [{b}, {hkv}, {s}, {d}] {dtype} "
              f"causal: kernel {t['ms']:.4f} ms (CUDA events around one "
              f"call, median of 21; {t['tflops']:.0f} TFLOP/s), device "
              f"time {t['device_ms']:.4f} ms (a CUDA graph of 20 calls); plain "
              f"{t['plain_ms']:.3f} ms (median of 5); "
              f"scaled_dot_product_attention {t['library_ms']:.4f} ms, "
              f"device time {t['library_device_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        k5[key] = timed["d64"][key]
    log["flash"] = dict(cases=rows, **timed)


def free_card() -> None:
    """Return what earlier phases left to the allocator to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_recsys(log):
    """bert4rec serving at its published size: ``serve_recsys`` at the
    ``serve_p99`` batch and the ``retrieval_cand`` candidate set; the
    card against the CPU on the same weights. Returns the model and the
    served sequences, for ``phase_embedding_bag``."""
    cfg = get_config("bert4rec")
    dev = torch.device("cuda")
    batch = recsys_shape("serve_p99").d("batch")
    n_cand = recsys_shape("retrieval_cand").d("n_candidates")
    bulk = recsys_shape("serve_bulk").d("batch")
    torch.cuda.reset_peak_memory_stats()
    model, t_init = wall(lambda: build_defs(cfg, device=dev,
                                            seed=RECSYS["seed"]))
    n_params = count_params(model)
    require(n_params == BERT4REC_PARAMS,
            f"bert4rec has {n_params} parameters, not {BERT4REC_PARAMS}")
    print(f"[recsys] bert4rec: {n_params} float32 parameters "
          f"({n_params * 4 / 1e6:.1f} MB) drawn in {t_init:.2f} s; item "
          f"table {tuple(model.items.shape)}")
    serve_recsys(cfg, batch, device=dev, model=model)  # warm-up: cuBLAS

    # the main path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    serve_times, retrieval_times = [], []
    for _ in range(RECSYS["reps"]):
        out = None  # the previous call's 2.05 GB of logits go first
        out = serve_recsys(cfg, batch, device=dev, model=model,
                           seed=RECSYS["seed"])
        serve_times.append(out.serve_ms)
        retrieval_times.append(out.retrieval_ms)
    counts = backend.launch_counts()
    serve_ms = statistics.median(serve_times)
    retrieval_ms = statistics.median(retrieval_times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(tuple(out.scores.shape) == (batch, cfg.padded_items)
            and bool(torch.isfinite(out.scores).all()),
            f"[recsys] scores {tuple(out.scores.shape)} or not finite")
    require(tuple(out.retrieval.shape) == (1, n_cand)
            and bool(torch.isfinite(out.retrieval).all()),
            f"[recsys] retrieval {tuple(out.retrieval.shape)} or not finite")
    require(bool((out.top_items >= 0).all())
            and bool((out.top_items < cfg.padded_items).all()),
            "[recsys] top items outside the table")
    print(f"[recsys] serve_p99: batch {batch}, seq {cfg.seq_len}, scores "
          f"{tuple(out.scores.shape)} float32: {serve_ms:.3f} ms per batch "
          f"(median of {RECSYS['reps']}: "
          f"{[round(t, 3) for t in serve_times]}); retrieval_cand: 1 user "
          f"x {n_cand} candidates {retrieval_ms:.3f} ms (median); peak "
          f"memory {peak_gb:.2f} GB; kernel launches on this path {counts} "
          "(the attention is plain torch, as it is plain jnp in JAX)")
    print(f"[recsys] serve_bulk (batch {bulk}) is not served: its logits "
          f"would take {bulk} x {cfg.padded_items} float32 = "
          f"{bulk * cfg.padded_items * 4 / 1e12:.2f} TB; its EmbeddingBag "
          "shape runs in [embedding_bag]")

    # the card against the CPU on the same weights
    rows = RECSYS["check_rows"]
    seqs, cands = recsys_requests(cfg, batch, seed=RECSYS["seed"])
    m_cpu = copy.deepcopy(model).to("cpu")
    want = m_cpu.serve_scores(seqs[:rows])
    got = out.scores[:rows].cpu()
    r_want = m_cpu.retrieval_scores(seqs[:1], cands)
    r_got = out.retrieval.cpu()
    del m_cpu
    errs = {}
    for what, g, w in (("serve", got, want), ("retrieval", r_got, r_want)):
        err = float((g - w).abs().max())
        top = float(w.abs().max())
        k = RECSYS["top"]
        same = torch.equal(
            torch.argsort(g, dim=-1, descending=True, stable=True)[:, :k],
            torch.argsort(w, dim=-1, descending=True, stable=True)[:, :k])
        require(err <= RECSYS_TOL * top and same,
                f"[recsys] {what}: card and CPU differ by {err} (largest "
                f"|score| {top}); top-{k} ids equal: {same}")
        errs[what] = dict(max_abs_diff=err, largest=top)
        print(f"[recsys] {what}, card against CPU on the same weights "
              f"({g.shape[0]} rows x {g.shape[1]}): max abs diff {err!r} "
              f"(largest |score| {top!r}, tolerance {RECSYS_TOL * top!r}); "
              f"top-{k} ids equal")

    # where the time goes: one serve_scores call
    seqs_dev = seqs.to(dev)
    log["recsys_profile"] = profiled(lambda: model.serve_scores(seqs_dev),
                                     "[recsys] serve_scores, batch 512")

    # the smoke-size model on the card against the CPU
    small = get_config("bert4rec", reduced=True)
    s_cpu = build_defs(small, device="cpu", seed=0)
    r_gpu = serve_recsys(small, 8, device=dev,
                         model=copy.deepcopy(s_cpu).to(dev))
    r_cpu = serve_recsys(small, 8, device="cpu", model=s_cpu)
    same = (torch.equal(r_gpu.top_items.cpu(), r_cpu.top_items)
            and torch.equal(r_gpu.retrieval_top.cpu(), r_cpu.retrieval_top))
    small_diff = float((r_gpu.scores.cpu() - r_cpu.scores).abs().max())
    require(same and small_diff <= SMOKE_TOL,
            f"[recsys] smoke model: card and CPU differ (ids equal: {same}, "
            f"scores {small_diff})")
    print(f"[recsys] bert4rec-smoke: card == CPU top items and top-5 "
          f"candidates, scores max abs diff {small_diff!r}")
    log["recsys"] = dict(params=n_params, batch=batch, serve_ms=serve_ms,
                         serve_ms_all=serve_times,
                         retrieval_ms=retrieval_ms, n_candidates=n_cand,
                         peak_gb=peak_gb, launches=counts, card_vs_cpu=errs,
                         smoke_diff=small_diff,
                         top_items=out.top_items[:8].tolist())
    return model, seqs


def bag_bytes(idx, d: int, v: int) -> tuple[float, float, float]:
    """(bytes, float32 operations, gathered bytes) of one EmbeddingBag on
    these bags: idx and w read once, out written once, and the rows the
    non-padding entries gather, at most the whole table once; two
    operations per gathered float."""
    b, l = idx.shape
    entries = float((idx >= 0).sum())
    gathered = entries * d * 4
    return (8.0 * b * l + 4.0 * b * d + min(gathered, 4.0 * v * d),
            2.0 * entries * d, gathered)


def padded_bags(idx, gen, pad: float):
    """idx with a ``pad`` share of its entries set to -1, and uniform(0, 1)
    weights."""
    idx = torch.where(torch.rand(idx.shape, generator=gen,
                                 device=idx.device) < pad, -1, idx)
    return idx.to(torch.int32), torch.rand(idx.shape, generator=gen,
                                           device=idx.device)


def ptxas_summary(source: str) -> list[str]:
    """Each kernel of ``source`` in the build log, with its registers and
    spills (empty when the library came from an earlier build)."""
    part = backend.BUILD_INFO.get("ptxas", "").split(f"== {source}")
    if len(part) < 2:
        return []
    out, name = [], None
    for ln in part[1].split("\n== ")[0].splitlines():
        if "entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln and name:
            spills = ln.strip()
        elif "registers" in ln and name:
            regs = ln.split(":", 1)[-1].strip()
            out.append(f"{name}: {regs}; {spills}")
            name = None
    return out


def bag_route_text(plan, d: int) -> str:
    if plan.route == "A":
        return f"route A, {plan.slices} slices a bag, {plan.blocks} blocks"
    return (f"route B, {plan.windows} windows of {plan.window_rows} rows "
            f"({plan.window_rows * d * 4 / 2**20:.2f} MiB), {plan.passes} "
            f"passes of {plan.bags_per_block} bags x {plan.blocks} blocks, "
            f"{plan.smem_bytes} B of shared memory, "
            f"scratch {plan.scratch_bytes / 1e6:.1f} MB")


def phase_embedding_bag(log, kernels, model, seqs):
    """K6 through the recsys layer's ``embedding_bag(use_kernel=True)`` on
    the served model's own item table: route A on the ``serve_p99`` bags,
    route B on the ``serve_bulk`` bags."""
    dev = torch.device("cuda")
    table = model.items.detach()
    v, d = table.shape
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(BAGS["seed"])
    bulk = recsys_shape("serve_bulk").d("batch")
    p99 = padded_bags(seqs.to(dev), gen, BAGS["pad"])
    big = padded_bags(torch.randint(0, cfg.n_items, (bulk, cfg.seq_len),
                                    generator=gen, device=dev), gen,
                      BAGS["pad"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bags = {"serve_p99": p99, "serve_bulk": big}
    plans = {k: K6.plan_route(*x[0].shape, v, d, sms) for k, x in bags.items()}
    require((plans["serve_p99"].route, plans["serve_bulk"].route)
            == ("A", "B"), f"[embedding_bag] routes {plans}")

    # the path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    out_p99 = embedding.embedding_bag(table, *p99, use_kernel=True)
    out_big = embedding.embedding_bag(table, *big, use_kernel=True)
    counts = backend.launch_counts()
    require(counts["embedding_bag"] == 2,
            f"[embedding_bag] {counts['embedding_bag']} kernel launches for "
            f"two calls (one a call, either route): {counts}")
    kernels["embedding_bag"]["launches"] = counts["embedding_bag"]
    sync()

    tol = BAGS["tol"]
    k6log = kernels["embedding_bag"]
    k6log["max_abs_err"] = 0.0

    def hold(got, idx, w, what):
        want = embedding_bag_plain(idx, w, table)
        err = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=tol, atol=tol),
                f"[embedding_bag] {what}: kernel differs from plain by {err}")
        k6log["max_abs_err"] = max(k6log["max_abs_err"], err)

    hold(out_p99, *p99, "serve_p99 bags (route A)")
    for c in range(0, bulk, BAGS["chunk"]):
        sl = slice(c, c + BAGS["chunk"])
        hold(out_big[sl], big[0][sl], big[1][sl],
             f"bulk bags {c}.. (route B)")
    # two calls give identical bits
    for what, (idx, w), first in (("serve_p99", p99, out_p99),
                                  ("serve_bulk", big, out_big)):
        again = embedding.embedding_bag(table, idx, w, use_kernel=True)
        require(torch.equal(again, first),
                f"[embedding_bag] {what}: two calls differ")
    del again
    # bags of padding only, and an index V (clipped to row V - 1), through
    # each route
    for what, (idx, w) in (("route A", (x[:64] for x in p99)),
                           ("route B", big)):
        idx = idx.clone()
        idx[3], idx[10] = -1, -1
        idx[5, 7], idx[6, 0] = v, v
        got = embedding.embedding_bag(table, idx, w, use_kernel=True)
        sync()
        hold(got, idx, w, f"{what}: padding-only bags and index V")
        require(bool((got[[3, 10]] == 0).all()),
                f"[embedding_bag] {what}: a bag of padding only is not "
                "exactly 0")
        del got, idx
    print(f"[embedding_bag] table {tuple(table.shape)}: serve_p99 bags "
          f"{tuple(p99[0].shape)} and bulk bags {tuple(big[0].shape)} (10% "
          f"padding): kernel == plain within {tol} (max abs err "
          f"{k6log['max_abs_err']!r}); two calls bit for bit identical; "
          "padding-only bags exactly 0; index V reads row V - 1, through "
          "both routes")
    regs = ptxas_summary("embedding_bag.cu")
    for ln in regs:
        print(f"[embedding_bag] ptxas {ln}")

    # timed, with the library call as a yardstick: -1 mapped to row 0 at
    # weight 0, prepared outside the timed call
    rows = []
    for what, (idx, w) in bags.items():
        plan = plans[what]
        lib_idx = idx.clamp(0, v - 1)
        lib_w = torch.where(idx >= 0, w, 0.0)
        lib = torch.nn.functional.embedding_bag(
            lib_idx, table, mode="sum", per_sample_weights=lib_w)
        require(torch.allclose(lib, embedding_bag_plain(idx, w, table),
                               rtol=tol, atol=tol),
                f"[embedding_bag] {what}: the library call disagrees")
        del lib

        def call(idx=idx, w=w):
            return embedding.embedding_bag(table, idx, w, use_kernel=True)

        def library(lib_idx=lib_idx, lib_w=lib_w):
            return torch.nn.functional.embedding_bag(
                lib_idx, table, mode="sum", per_sample_weights=lib_w)

        row = dict(shape=tuple(idx.shape), plan=dataclasses.asdict(plan),
                   ms=event_ms(call, 21), device_ms=graph_ms(call))
        row["plain_ms"] = event_ms(lambda: embedding_bag_plain(idx, w, table),
                                   3)
        row["library_ms"] = event_ms(library, 21)
        row["library_device_ms"] = graph_ms(library)
        nbytes, ops, gathered = bag_bytes(idx, d, v)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops)
        row["gathered_gb"] = gathered / 1e9
        row["gathered_bound_ms"] = (nbytes - min(gathered, 4.0 * v * d)
                                    + gathered) / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        print(f"[embedding_bag] {what} {row['shape']}, "
              f"{bag_route_text(plan, d)}: kernel {row['ms']:.4f} ms "
              f"(events, median of 21), device {row['device_ms']:.4f} ms "
              f"(CUDA graph of 20); plain {row['plain_ms']:.3f} ms (median "
              f"of 3); F.embedding_bag {row['library_ms']:.4f} ms, device "
              f"{row['library_device_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, the table read "
              f"at most once); gathered rows {row['gathered_gb']:.3f} GB, "
              f"{row['gathered_bound_ms']:.4f} ms if every gathered row came "
              "from device memory")
    log["embedding_bag"] = dict(rows=rows, max_abs_err=k6log["max_abs_err"],
                                ptxas=regs)
    log["embedding_bag"].update(bag_bulk_split(table, *big, plans["serve_bulk"]))
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        k6log[key] = rows[-1][key]


def bag_bulk_split(table, idx, w, plan) -> dict:
    """Route B at ``serve_bulk``: the L2 yardstick (route A, one slice a
    bag, on the bags folded into the table's first window, which the L2
    holds) and the per-block split of one call into sort, wait, walk and
    write."""
    v, d = table.shape
    yard = dataclasses.replace(plan, route="A", slices=1, windows=1,
                               window_rows=v, passes=1, bags_per_block=8,
                               blocks=(idx.shape[0] + 7) // 8, smem_bytes=0,
                               scratch_bytes=0)
    rows = plan.window_rows
    folded = torch.where(idx >= 0, idx % rows, idx).to(torch.int32)
    got = K6._launch(folded, w, table, yard)
    require(torch.allclose(got, embedding_bag_plain(folded, w, table),
                           rtol=BAGS["tol"], atol=BAGS["tol"]),
            "[embedding_bag] the folded bags disagree")
    del got
    out = dict(yardstick_mib=rows * d * 4 / 2**20, yardstick_ms=graph_ms(
        lambda: K6._launch(folded, w, table, yard)))
    del folded
    print(f"[embedding_bag] L2 yardstick: the bulk bags folded into the "
          f"first {rows} rows ({out['yardstick_mib']:.2f} MiB, one window) "
          f"through route A, one slice a bag: device "
          f"{out['yardstick_ms']:.4f} ms (CUDA graph of 20)")
    split = torch.zeros((plan.blocks, 4), dtype=torch.int64,
                        device=table.device)
    K6._launch(idx, w, table, plan, split)  # warm
    split.zero_()
    _, t = wall(lambda: K6._launch(idx, w, table, plan, split))
    us = (split.double() / 1e3).cpu()
    names = ("sort", "wait", "walk", "write")
    out["split_us"] = {n: dict(mean=float(us[:, i].mean()),
                               max=float(us[:, i].max()))
                       for i, n in enumerate(names)}
    print(f"[embedding_bag] route B split of one bulk call ({t * 1e3:.3f} ms "
          f"host, sync to sync), per block mean / max over {plan.blocks}: "
          + ", ".join(f"{n} {x['mean']:.1f} / {x['max']:.1f} us"
                      for n, x in out["split_us"].items())
          + f"; {plan.passes * plan.windows} window steps")
    return out


def tile_inputs(kind: str, m: int, n: int, gen):
    """(a, a2, u, v) of a dense cycle-gain tile on the card."""
    dev = torch.device("cuda")
    if kind == "bench":  # benchmarks/bench_kernels.py's draw
        rng = np.random.default_rng(0)
        a = rng.uniform(0.1, 1, (m, n)) * (rng.random((m, n)) < 0.3)
        a2 = rng.uniform(0.1, 1, (m, n)) * (rng.random((m, n)) < 0.3)
        u, v = rng.uniform(0, 1, m), rng.uniform(0, 1, n)
        return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in (a, a2, u, v))
    if kind == "absent":
        return (torch.zeros((m, n), device=dev),
                torch.zeros((m, n), device=dev), torch.zeros(m, device=dev),
                torch.zeros(n, device=dev))
    if kind == "ties":  # small integers: most columns tie
        a, a2 = (torch.randint(0, 4, (m, n), generator=gen, device=dev)
                 .float() for _ in range(2))
        u, v = (torch.randint(0, 3, (k,), generator=gen, device=dev).float()
                for k in (m, n))
        return a, a2, u, v
    out = []
    for _ in range(2):  # uniform(0.1, 1) at density 0.3
        a = torch.rand((m, n), generator=gen, device=dev).mul_(0.9).add_(0.1)
        a.mul_(torch.rand((m, n), generator=gen, device=dev) < 0.3)
        out.append(a)
    return (*out, torch.rand(m, generator=gen, device=dev),
            torch.rand(n, generator=gen, device=dev))


def tile_bytes(m: int, n: int) -> tuple[float, float]:
    """Bytes and float32 operations of one dense cycle-gain tile: A, A2, u
    and v read once, gain and row written once; three operations per
    entry."""
    return 8.0 * m * n + 4.0 * (m + n) + 8.0 * n, 3.0 * m * n


def phase_cycle_gain(log, kernels):
    """K3 through ``cycle_gain_padded`` and ``swap_gains``, bit for bit
    against its plain version, and timed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SWAP["seed"])
    tiles = [(name, tile_inputs(kind, m, n, gen)) for name, m, n, kind
             in TILES]
    t, e = SWAP["t"], SWAP["e"]
    aff = torch.randn((t, e), generator=gen, device=dev)
    assign = torch.randint(0, e, (t,), generator=gen, device=dev)
    tok = torch.gather(aff, 1, assign[:, None])[:, 0]

    # the path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    outs = [cycle_gain_padded(*args) for _, args in tiles]
    swap = swap_gains(aff, assign, tok)
    counts = backend.launch_counts()
    require(counts["cycle_gain"] == len(tiles) + 1,
            f"[cycle_gain] {counts['cycle_gain']} kernel launches for "
            f"{len(tiles) + 1} calls: {counts}")
    kernels["cycle_gain"]["launches"] = counts["cycle_gain"]
    sync()

    k3 = kernels["cycle_gain"]
    k3["max_abs_err"] = 0.0
    rows = []
    for (name, args), got in zip(tiles, outs):
        want = cycle_gain_plain(*args)
        k3["max_abs_err"] = max(k3["max_abs_err"], assert_identical(
            got, want, f"[cycle_gain] {name}"))
        require(torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32)),
                f"[cycle_gain] {name}: gains differ in their bits")
        found = int((got[1] >= 0).sum())
        rows.append(dict(case=name, shape=tuple(args[0].shape),
                         columns_with_row=found))
        print(f"[cycle_gain] {name}: kernel == plain bit for bit (gains "
              f"and rows); {found} of {args[0].shape[1]} columns have a row")
    want = swap_gains(aff, assign, tok, use_kernel=False)
    assert_identical(swap, want, "[cycle_gain] swap_gains")
    require(torch.equal(swap[0].view(torch.int32), want[0].view(torch.int32)),
            "[cycle_gain] swap_gains: gains differ in their bits")
    print(f"[cycle_gain] swap_gains (T {t}, E {e}): kernel == plain bit for "
          f"bit; {int((swap[0] > 0).sum())} tokens have a positive swap")
    del outs, want

    # timed on the 16,384 x 16,384 pair
    name, args = tiles[1]
    m, n = args[0].shape
    k3["ms"] = event_ms(lambda: cycle_gain(*args), 21)
    k3["plain_ms"] = event_ms(lambda: cycle_gain_plain(*args), 3)
    k3["bound_ms"], k3["bound_by"] = bound_ms(*tile_bytes(m, n))
    small = tiles[0][1]
    small_ms = event_ms(lambda: cycle_gain(*small), 21)
    small_plain_ms = event_ms(lambda: cycle_gain_plain(*small), 5)
    a = aff[:, assign]
    a2 = a.T.contiguous()
    swap_ms = event_ms(lambda: cycle_gain(a, a2, tok, tok), 21)
    swap_entry_ms = event_ms(lambda: swap_gains(aff, assign, tok), 21)
    swap_plain_ms = event_ms(lambda: swap_gains(aff, assign, tok,
                                                use_kernel=False), 5)
    print(f"[cycle_gain] {name}: kernel {k3['ms']:.4f} ms (median of 21), "
          f"plain {k3['plain_ms']:.3f} ms (median of 3), bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']}); 512x512: kernel "
          f"{small_ms:.4f} ms, plain {small_plain_ms:.4f} ms, bound "
          f"{bound_ms(*tile_bytes(512, 512))[0]:.5f} ms; swap_gains "
          f"(T {t}): kernel {swap_ms:.4f} ms, entry with the gather and "
          f"transpose {swap_entry_ms:.4f} ms, plain {swap_plain_ms:.4f} ms, "
          f"bound {bound_ms(*tile_bytes(t, t))[0]:.5f} ms")
    log["cycle_gain"] = dict(cases=rows, ms=k3["ms"], plain_ms=k3["plain_ms"],
                             bound_ms=k3["bound_ms"], small_ms=small_ms,
                             small_plain_ms=small_plain_ms, swap_ms=swap_ms,
                             swap_entry_ms=swap_entry_ms,
                             swap_plain_ms=swap_plain_ms)


def phase_moe(log, kernels):
    """MoE serving on qwen2-moe-a2.7b at full width and depth with the AWPM
    router; returns layer 0's router input at the prefill and the decode
    shape, for ``phase_router_swap``."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", router="awpm"),
                              attention_impl="cuda")
    md = cfg.moe
    dev = torch.device("cuda")
    b, plen, steps = MOE["batch"], MOE["prompt_len"], MOE["decode_steps"]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    model, t_init = wall(lambda: build_defs(cfg, device=dev, seed=MOE["seed"]))
    n_params = count_params(model)
    require(n_params == QWEN2_MOE_PARAMS,
            f"qwen2-moe-a2.7b has {n_params} parameters, not "
            f"{QWEN2_MOE_PARAMS}")
    print(f"[moe] qwen2-moe-a2.7b: {n_params} parameters, float32 weights "
          f"drawn in {t_init:.2f} s; {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB on the card")
    serve_lm(cfg, b, plen, 2, device=dev, model=model)  # warm-up

    # the main path, as a user calls it; the counts are read right after
    backend.reset_launch_counts()
    out = serve_lm(cfg, b, plen, steps, device=dev, model=model)
    counts = backend.launch_counts()
    per_forward = cfg.n_layers * md.top_k * md.router_swap_rounds
    require(counts["router_swap"] == per_forward * steps,
            f"[moe] {counts['router_swap']} K4 launches over a prefill and "
            f"{steps - 1} decode steps, not {per_forward} per forward")
    require(counts["flash_attention"] == cfg.n_layers,
            f"[moe] {counts['flash_attention']} K5 launches, not one per "
            f"layer ({cfg.n_layers})")
    kernels["router_swap"]["launches"] = counts["router_swap"]
    ids = out.ids
    require(tuple(ids.shape) == (b, steps) and bool((ids >= 0).all())
            and bool((ids < cfg.vocab).all()), f"[moe] ids {tuple(ids.shape)}")
    require(bool(torch.isfinite(out.last_logits).all()),
            "[moe] non-finite logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one prefill counted alone, every MoE layer's router logits captured
    tokens = prompt_tokens(cfg, b, plen, MOE["seed"]).to(dev)
    captured = []

    def keep(module, inputs, output):
        captured.append(output)

    hooks = [bp.ffn.router.register_forward_hook(keep)
             for bp in model.moe_blocks]
    backend.reset_launch_counts()
    try:
        (logits, _), t_pf = wall(lambda: T.prefill(model, tokens, cfg))
    finally:
        for h in hooks:
            h.remove()
    pf = backend.launch_counts()
    require(pf["router_swap"] == per_forward
            and pf["flash_attention"] == cfg.n_layers,
            f"[moe] one prefill launched {pf}: K4 must launch {per_forward} "
            f"times, K5 {cfg.n_layers}")
    require(torch.equal(logits, out.last_logits),
            "[moe] a second prefill gave other logits")
    print(f"[moe] AWPM router, batch {b}, prompt {plen}, {steps} decode "
          f"steps: prefill {out.prefill_ms:.1f} ms, decode "
          f"{out.decode_ms:.2f} ms/token; peak memory {peak_gb:.2f} GB; one "
          f"prefill launches K4 {pf['router_swap']} times and K5 "
          f"{pf['flash_attention']} times ({t_pf * 1e3:.1f} ms); first ids "
          f"{ids[:, :8].tolist()}")

    # the routing of three layers through K4 and through the plain search
    routes = []
    for li in MOE_CHECK_LAYERS:
        lgp, cap_round = M.awpm_blocks(captured[li], md)
        got, t_k = wall(lambda: M.awpm_route_batched(
            lgp, md.top_k, cap_round, md.router_swap_rounds))
        want, t_p = wall(lambda: M.awpm_route_batched(
            lgp, md.top_k, cap_round, md.router_swap_rounds,
            use_kernel=False))
        for a, c, what in zip(got[:3], want[:3],
                              ("experts", "slots", "weights")):
            require(torch.equal(a, c), f"[moe] layer {li}: {what} through K4 "
                    f"differ from the plain swap search")
        routes.append(dict(layer=li, groups=tuple(lgp.shape),
                           kernel_ms=t_k * 1e3, plain_ms=t_p * 1e3))
        print(f"[moe] layer {li}: AWPM routing of {tuple(lgp.shape)} through "
              f"K4 == plain swap search (experts, slots, weights); "
              f"{t_k * 1e3:.1f} ms with K4, {t_p * 1e3:.1f} ms plain")

    # the top-k router on the same weights
    topk_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        md, router="topk"))
    serve_lm(topk_cfg, b, plen, 2, device=dev, model=model)  # warm-up
    backend.reset_launch_counts()
    out_t = serve_lm(topk_cfg, b, plen, steps, device=dev, model=model)
    require(backend.launch_counts()["router_swap"] == 0,
            "[moe] the top-k router launched K4")
    require(bool(torch.isfinite(out_t.last_logits).all())
            and bool((out_t.ids >= 0).all())
            and bool((out_t.ids < cfg.vocab).all()),
            "[moe] top-k: non-finite logits or ids outside the vocabulary")
    print(f"[moe] top-k router, same weights: prefill {out_t.prefill_ms:.1f} "
          f"ms, decode {out_t.decode_ms:.2f} ms/token; first ids "
          f"{out_t.ids[:, :8].tolist()}")

    # where the time goes: one prefill, then one decode step
    log["moe_profile_prefill"] = profiled(
        lambda: T.prefill(model, tokens, cfg), "[moe] prefill",
        watch=("router_swap", "flash_fwd"))
    cache = grow_cache(T.prefill(model, tokens, cfg)[1], cfg, plen + 2)
    tok = logits.argmax(-1)[:, None]
    log["moe_profile_decode"] = profiled(
        lambda: T.decode_step(model, cache, tok, plen, cfg),
        "[moe] 1 decode step", watch=("router_swap",))
    # layer 0's router logits in a decode step
    dec = []
    h = model.moe_blocks[0].ffn.router.register_forward_hook(
        lambda module, inputs, output: dec.append(output))
    try:
        T.decode_step(model, cache, tok, plen + 1, cfg)
    finally:
        h.remove()
    swap_inputs = dict(prefill=M.awpm_blocks(captured[0], md),
                       decode=M.awpm_blocks(dec[0], md))
    log["moe"] = dict(params=n_params, batch=b, prompt_len=plen,
                      decode_steps=steps, prefill_ms=out.prefill_ms,
                      decode_ms_per_token=out.decode_ms, peak_gb=peak_gb,
                      prefill_alone_ms=t_pf * 1e3, launches=pf,
                      routes=routes, topk_prefill_ms=out_t.prefill_ms,
                      topk_decode_ms_per_token=out_t.decode_ms,
                      first_ids=ids[:, :8].tolist())
    del model, cache, out, out_t, logits, captured
    free_card()

    # the smoke-size model (float32) on the card against the CPU
    small = dataclasses.replace(
        get_config("qwen2-moe-a2.7b", reduced=True, router="awpm"),
        attention_impl="cuda")
    m_cpu = build_defs(small, device="cpu", seed=0)
    r_gpu = serve_lm(small, 2, 128, 8, device=dev,
                     model=copy.deepcopy(m_cpu).to(dev))
    r_cpu = serve_lm(small, 2, 128, 8, device="cpu", model=m_cpu)
    small_diff = float((r_gpu.last_logits.cpu() - r_cpu.last_logits)
                       .abs().max())
    same_ids = torch.equal(r_gpu.ids.cpu(), r_cpu.ids)
    print(f"[moe] qwen2-moe-a2.7b-smoke float32, AWPM router: card and CPU "
          f"ids equal: {same_ids}; logits max abs diff {small_diff!r}")
    require(same_ids and small_diff <= SMOKE_TOL,
            f"[moe] smoke model: card and CPU differ (ids equal: {same_ids}, "
            f"logits {small_diff})")
    log["moe"]["smoke_diff"] = small_diff
    return swap_inputs


def phase_router_swap(log, kernels, inputs):
    """K4 against its plain version, bit for bit, on the router's own
    inputs (layer 0's first routing round: the balanced assignment of its
    captured logits), on a random case and on an odd (T, E) with int32
    ids; timed at the prefill shape, through the kernel's wrapper and
    through the entry the router calls, with the entry's device launches
    counted and K4's device time per launch read from the prefill
    profile."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for what in ("prefill", "decode"):
        lgp, cap_round = inputs[what]
        aff = lgp.float()
        cases.append((f"{what} layer 0", aff,
                      M.balanced_assign_batched(aff, cap_round)))
    cases.append(("random (300, 60)",
                  torch.randn((1, 300, 60), generator=gen, device=dev),
                  torch.randint(0, 60, (1, 300), generator=gen, device=dev)))
    cases.append(("odd (T, E) = (1001, 13), int32 ids",
                  torch.randn((8, 1001, 13), generator=gen, device=dev),
                  torch.randint(0, 13, (8, 1001), generator=gen, device=dev,
                                dtype=torch.int32)))
    k4 = kernels["router_swap"]
    k4["max_abs_err"] = 0.0
    rows = []
    for what, aff, assign in cases:
        cur = torch.gather(aff, 2, assign.long()[..., None])[..., 0]
        got = router_swap_padded_batched(aff, assign, cur)
        sync()
        want = router_swap_plain_batched(aff, assign, cur)
        k4["max_abs_err"] = max(k4["max_abs_err"], assert_identical(
            got, want, f"[router_swap] {what}"))
        require(torch.equal(got[0].view(torch.int32),
                            want[0].view(torch.int32)),
                f"[router_swap] {what}: gains differ in their bits")
        found = int((got[1] >= 0).sum())
        rows.append(dict(case=what, shape=tuple(aff.shape), with_partner=found))
        print(f"[router_swap] {what} {tuple(aff.shape)}: kernel == plain bit "
              f"for bit (gains and partners); {found} tokens have a partner")
    # timed on the prefill shape
    _, aff, assign = cases[0]
    cur = torch.gather(aff, 2, assign[..., None])[..., 0]
    k4["ms"] = event_ms(lambda: router_swap(aff, assign, cur), 21)
    k4["plain_ms"] = event_ms(lambda: router_swap_plain_batched(
        aff, assign, cur), 5)
    entry_ms = event_ms(lambda: router_swap_padded_batched(aff, assign, cur),
                        21)
    entry_nodes = graph_node_types(
        lambda: router_swap_padded_batched(aff, assign, cur))
    require(entry_nodes == [0], f"[router_swap] the entry put {entry_nodes} "
            f"on the stream, not one kernel")
    alone_ms = graph_ms(lambda: router_swap(aff, assign, cur))
    watch = log["moe_profile_prefill"]["watch"]["router_swap"]
    per_launch = watch["device_ms"] / watch["count"]
    k4["bound_ms"], k4["bound_by"] = bound_ms(*swap_work(assign,
                                                         aff.shape[2]))
    print(f"[router_swap] {tuple(aff.shape)}: kernel {k4['ms']:.4f} ms "
          f"(median of 21, CUDA events around one launch), entry "
          f"{entry_ms:.4f} ms (one kernel on the stream), plain "
          f"{k4['plain_ms']:.3f} ms (median of 5), bound "
          f"{k4['bound_ms']:.5f} ms ({k4['bound_by']}); device time "
          f"{alone_ms:.5f} ms a launch (a CUDA graph of 20 launches), "
          f"{per_launch:.5f} ms in the prefill profile ({watch['count']} "
          f"launches, {watch['device_ms']:.3f} ms)")
    log["router_swap"] = dict(cases=rows, ms=k4["ms"], entry_ms=entry_ms,
                              entry_nodes=entry_nodes,
                              plain_ms=k4["plain_ms"],
                              bound_ms=k4["bound_ms"], device_ms=alone_ms,
                              profile_ms_per_launch=per_launch)


def dispatch_tool():
    """``tools/dispatch_table.py`` of this checkout, as a module: the
    measurement that wrote the committed table."""
    spec = importlib.util.spec_from_file_location(
        "dispatch_table", ROOT / "tools" / "dispatch_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_dispatch(log, single_run, batch_run):
    """[dispatch] The committed dispatch table: "auto" resolves to each
    shape class's winner with source "table" (phases 2 and 3 are the
    large classes), and one class on each side of ``SMALL_N`` re-timed
    here as the table was measured, printed beside its entries."""
    card = log["card"]
    table = kdispatch.load_table()
    require(table is not None, f"[dispatch] no table at "
            f"{kdispatch.table_path()}")
    entries, meta = table["entries"], table["metadata"]
    print(f"[dispatch] {kdispatch.table_path()}: measured "
          f"on {meta.get('card')} (torch {meta.get('torch')}, CUDA "
          f"{meta.get('cuda')}); host {meta.get('host_cpu')}")
    for key, e in sorted(entries.items()):
        us = e["us_per_iter"]
        print(f"[dispatch]   {key:<20} winner {e['winner']:<16} us/round "
              + ", ".join(f"{b} {us[b]:.1f}" for b in us)
              + (f"; cut {e['cut']}" if "cut" in e else ""))
    # "auto" on a problem of each class
    gen = [graph.generate(128, avg_degree=8.0,
                          kind=graph.SUITE_KINDS[i % len(graph.SUITE_KINDS)],
                          seed=i) for i in range(BATCH["b"])]
    runs = {"single_small": solve(MatchingProblem.from_graph(gen[0])),
            "single_large": single_run[6],
            "batched_small": solve(MatchingProblem.stack(gen)),
            "batched_large": batch_run[1]}
    for klass, r in runs.items():
        want = entries[f"{CARD.type}/{klass}"]["winner"]
        require((r.execution.backend, r.execution.source) == (want, "table"),
                f"[dispatch] {klass}: auto ran {r.execution.backend} "
                f"({r.execution.source}), the table's winner is {want}")
    print(f"[dispatch] auto resolved to each class's winner, source "
          f"\"table\": " + ", ".join(f"{k} {r.execution.backend}"
                                     for k, r in runs.items()))
    # one class on each side of SMALL_N, timed as the tool times them
    tool = dispatch_tool()
    sizes = {k: tuple(v)
             for k, v in meta["runs"][CARD.type]["sizes"].items()}
    out = log["dispatch"] = {}
    for klass in ("single_small", "single_large"):
        cell = tool.measure_class(klass, sizes, CARD,
                                  DISPATCH["reps"], DISPATCH["limit_s"],
                                  log=lambda *a: None)
        e = entries[f"{CARD.type}/{klass}"]
        print(f"[dispatch] {klass} ({cell['workload']}) re-timed, ms a later "
              f"call now / in the table: " + ", ".join(
                  f"{b} {cell['ms'][b]:.3f} / {e['ms'][b]:.3f}"
                  for b in cell["ms"])
              + f"; winner now {cell['winner']}, table {e['winner']} "
              f"({card})")
        out[klass] = cell


def phase_paper_eval(log, kernels):
    """[paper_eval] The paper's evaluation (``repro_torch.experiments``)
    on the card: ``DEFAULT_SPEC`` (six fixtures and ten suite matrices of
    n = 96) and three suite matrices of n = 4,096, through the four local
    backends, "auto" and the 1x1 NCCL grid; every row certified, sound,
    perfect and identical to "reference" (``run_eval`` raises
    otherwise). Then the CLI over the paper's instances' stand-ins
    (:func:`paper_instances`)."""
    card = log["card"]
    (small, t, k) = launched(lambda: paper_eval.run_eval(
        paper_eval.DEFAULT_SPEC))
    (large, t_l, k_l) = launched(lambda: paper_eval.run_eval(PAPER_EVAL))
    rows = small + large
    engines = set(paper_eval.DEFAULT_BACKENDS) | {"grid1x1"}
    require({r.engine for r in rows} == engines,
            f"[paper_eval] engines {sorted({r.engine for r in rows})}")
    for r in rows:
        require(r.perfect and r.certified_sound and r.identical_to_reference
                and torch.device(r.device).type == CARD.type,
                f"[paper_eval] {r.name} [{r.engine}] {r}")
        if r.engine == "auto":
            require((r.backend, r.dispatch) == (auto_backend(r.n), "table"),
                    f"[paper_eval] {r.name}: auto ran {r.backend} "
                    f"({r.dispatch})")
    launches = {name: k[name] + k_l[name]
                for name in ("awac_sweep", "awac_persistent",
                             "mcm_persistent")}
    require(launches["awac_sweep"] >= 1 and launches["awac_persistent"] >= 1,
            f"[paper_eval] launches {launches}")
    kernels["awac_sweep"]["launches"] += launches["awac_sweep"]
    kernels["awac_persistent"]["launches"] += launches["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += launches["mcm_persistent"]
    print(paper_eval.to_markdown(rows))
    bounds = [r.ratio_bound for r in rows if r.ratio_bound is not None]
    worst = min(bounds)
    worst_row = next(r for r in rows if r.ratio_bound == worst)
    n_tight = sum(r.tight for r in rows)
    print(f"[paper_eval] {len(rows)} rows ({len(small)} in {t:.1f} s, "
          f"{len(large)} at n = {PAPER_EVAL['synthetic_n']} in {t_l:.1f} s): "
          f"all sound, perfect and identical to reference; {n_tight} "
          f"certified optimal; worst certified ratio bound {worst:.4f} "
          f"({worst_row.name}); K1 launches {launches['awac_sweep']}, K2 "
          f"{launches['awac_persistent']} ({card})")
    instances = paper_instances(card, kernels)
    log["paper_eval"] = dict(wall_s=[t, t_l], launches=launches,
                             worst_ratio_bound=worst,
                             records=[dataclasses.asdict(r) for r in rows],
                             instances=instances)


def write_standins(serve: pathlib.Path) -> list[str]:
    """``PAPER_STANDINS`` as the collection serves its instances:
    ``<serve>/<group>/<name>.tar.gz`` holding ``<name>/<name>.mtx``. Real
    general files, the last one real symmetric (its lower triangle, the
    planted matching kept in both orientations). Returns the names."""
    cfg = PAPER_STANDINS
    n, group = cfg["n"], cfg["group"]
    (serve / group).mkdir(parents=True)
    names = []
    for i, kind in enumerate(cfg["kinds"]):
        g = graph.generate(n, avg_degree=cfg["avg_degree"], kind=kind,
                           seed=cfg["seed"] + i)
        row, col = g.row[:g.nnz].astype(np.int64), g.col[:g.nnz]
        val = g.val[:g.nnz].astype(np.float64)
        symmetric = i == len(cfg["kinds"]) - 1
        name = f"standin_{kind}_n{n}" + ("_sym" if symmetric else "")
        if symmetric:
            lo, hi = np.maximum(row, col), np.minimum(row, col)
            _, keep = np.unique(lo * n + hi, return_index=True)
            row, col, val = lo[keep], hi[keep], val[keep]
        path = serve / f"{name}.mtx"
        mtx_io.write_mtx(path, row, col, val, shape=(n, n),
                         symmetry="symmetric" if symmetric else "general",
                         comment=f"synthetic stand-in ({kind}, seed "
                                 f"{cfg['seed'] + i}), not a SuiteSparse "
                                 f"instance")
        with tarfile.open(serve / group / f"{name}.tar.gz", "w:gz") as tf:
            tf.add(path, arcname=f"{name}/{name}.mtx")
        names.append(name)
    return names


def paper_instances(card: str, kernels: dict) -> dict:
    """[paper_eval]'s third pass, as a user runs the paper's instances:
    ``python -m repro_torch.experiments --download --instances ...
    --cache-dir ...`` over ``PAPER_STANDINS`` served from a ``file://``
    directory, then again over the filled cache with the URL gone. Every
    stand-in row must come from "suitesparse" in the paper's metric,
    perfect, sound, identical to "reference" and on the card, "auto" as
    the table says; the passes must agree and launch K1 and K2."""
    work = ROOT / "build" / "paper-instances"
    shutil.rmtree(work, ignore_errors=True)
    names = write_standins(work / "serve")
    group = PAPER_STANDINS["group"]
    argv = ["--download", "--instances",
            ",".join(f"{group}/{name}" for name in names),
            "--cache-dir", str(work / "cache"), "--suite-count", "0",
            "--no-persist"]
    base = suitesparse.BASE_URL
    passes, launches = [], {"awac_sweep": 0, "awac_persistent": 0,
                            "mcm_persistent": 0}
    t0 = time.perf_counter()
    try:
        for url in (work / "serve", work / "gone"):
            suitesparse.BASE_URL = f"file://{url}"
            (rows, t, k) = launched(lambda: paper_eval_cli.main(argv))
            passes.append((rows, t))
            for name in launches:
                launches[name] += k[name]
    finally:
        suitesparse.BASE_URL = base
    t_phase = time.perf_counter() - t0
    (rows, t), (again, t_again) = passes
    engines = set(paper_eval.DEFAULT_BACKENDS) | {"grid1x1"}
    mine = [r for r in rows if r.name in names]
    require(len(mine) == len(names) * len(engines)
            and {r.engine for r in mine} == engines,
            f"[paper_eval] stand-in rows {[(r.name, r.engine) for r in mine]}")
    require({r.source for r in rows if r.name not in names} == {"fixture"},
            "[paper_eval] a row that is no stand-in is no fixture")
    for r in rows:
        require(r.perfect and r.certified_sound and r.identical_to_reference
                and torch.device(r.device).type == CARD.type,
                f"[paper_eval] {r.name} [{r.engine}] {r}")
        if r.engine == "auto":
            require((r.backend, r.dispatch) == (auto_backend(r.n), "table"),
                    f"[paper_eval] {r.name}: auto ran {r.backend} "
                    f"({r.dispatch})")
    for r in mine:
        require(r.source == "suitesparse"
                and r.transform == "log2_scaled_nonneg"
                and r.n == PAPER_STANDINS["n"],
                f"[paper_eval] {r.name} [{r.engine}]: {r.source}, "
                f"{r.transform}, n = {r.n}")
    untimed = [[{k: v for k, v in dataclasses.asdict(r).items()
                 if k != "wall_s"} for r in p] for p in (rows, again)]
    require(untimed[0] == untimed[1],
            "[paper_eval] the filled cache's pass differs from the download's")
    require(launches["awac_sweep"] >= 1 and launches["awac_persistent"] >= 1,
            f"[paper_eval] stand-in launches {launches}")
    kernels["awac_sweep"]["launches"] += launches["awac_sweep"]
    kernels["awac_persistent"]["launches"] += launches["awac_persistent"]
    kernels["mcm_persistent"]["launches"] += launches["mcm_persistent"]
    nnz = {r.name: r.nnz for r in mine}
    for name in names:
        print(f"[paper_eval] {name} (nnz {nnz[name]}), ms a later call, "
              f"download / cache pass: " + ", ".join(
                  f"{r.engine} {r.wall_s * 1e3:.3f} / {a.wall_s * 1e3:.3f}"
                  for r, a in zip(rows, again) if r.name == name))
    bounds = [r.ratio_bound for r in mine if r.ratio_bound is not None]
    print(f"[paper_eval] --download of {len(names)} synthetic stand-ins "
          f"(not SuiteSparse instances; n = {PAPER_STANDINS['n']}) from "
          f"file:// tarballs, then from the filled cache with the URL gone: "
          f"{len(rows)} rows a pass ({len(mine)} of the stand-ins, source "
          f"\"suitesparse\", log2_scaled_nonneg), passes equal; "
          f"{t:.1f} s and {t_again:.1f} s, phase {t_phase:.1f} s; worst "
          f"certified ratio bound {min(bounds):.4f}; K1 launches "
          f"{launches['awac_sweep']}, K2 {launches['awac_persistent']} "
          f"({card})")
    return dict(names=names, wall_s=[t, t_again], phase_s=t_phase,
                launches=launches,
                records=[dataclasses.asdict(r) for r in mine])


def grad_margin(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max |got - want| over its largest |want|."""
    worst, at = 0.0, ""
    for name, w in want.items():
        err = float((got[name] - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        if err > worst:
            worst, at = err, name
    return worst, at


def compression_check(grads: dict, card: str) -> dict:
    """[train] step-1 gradients through ``compress_int8_psum`` on the 1x1
    NCCL grid's group and through ``compress_topk``, on the card and on
    the host CPU (a one-rank gloo group) from the same gradients: the int8
    payloads, the int32 sums and the kept indices must be equal bit for
    bit (and so must the scales, means, kept values and residuals).
    Prints and returns the time of each."""
    grid = make_grid(1, 1)  # the card: an NCCL group of one rank
    host_group = tdist.new_group([0], backend="gloo")
    cpu = {k: g.detach().cpu() for k, g in grads.items()}
    out, res = {}, {}
    for where, tree, group in (("card", grads, grid.col_group),
                               ("cpu", cpu, host_group)):
        st = gcomp.init_state(tree)
        # the first call also starts the group's communicator; a later
        # call is the steady state
        _, t_first = wall(lambda: gcomp.compress_int8_psum(tree, st, group))
        (mean, s8), t_int8 = wall(
            lambda: gcomp.compress_int8_psum(tree, st, group))
        (kept, sk), t_topk = wall(
            lambda: gcomp.compress_topk(tree, st, TOPK_FRAC))
        res[where] = dict(mean=mean, int8_residual=s8.residual, kept=kept,
                          topk_residual=sk.residual)
        out[where] = dict(int8_first_s=t_first, int8_s=t_int8,
                          topk_s=t_topk)
    for what, trees in res["card"].items():
        for name, x in trees.items():
            require(torch.equal(x.cpu(), res["cpu"][what][name]),
                    f"[train] {what} of {name} differs on the card from the "
                    f"CPU")
    n_kept = 0
    for name, g in grads.items():
        z = torch.zeros_like(g)
        a = gcomp.int8_allreduce(g, z, grid.col_group)
        c = gcomp.int8_allreduce(cpu[name], z.cpu(), host_group)
        for field in ("payload", "scale", "summed", "shared_scale"):
            x, y = getattr(a, field).cpu(), getattr(c, field)
            require(x.dtype == y.dtype and torch.equal(x, y),
                    f"[train] int8 exchange of {name}: {field} differs on "
                    f"the card from the CPU")
        idx = gcomp.topk_indices(g, TOPK_FRAC).cpu()
        require(torch.equal(idx, gcomp.topk_indices(cpu[name], TOPK_FRAC)),
                f"[train] top-k of {name}: the kept indices differ on the "
                f"card from the CPU")
        n_kept += idx.numel()
    tdist.destroy_process_group()
    n = sum(g.numel() for g in grads.values())
    print(f"[train] compressed step-1 gradients ({len(grads)} leaves, {n} "
          f"entries): int8 exchange (payload, scale, int32 sum, shared "
          f"scale, mean, residual) and top-k {TOPK_FRAC} ({n_kept} kept "
          f"indices, values, residual) equal on the card and the CPU, bit "
          f"for bit; compress_int8_psum {out['card']['int8_s'] * 1e3:.1f} ms "
          f"on the card (1x1 NCCL group; first call "
          f"{out['card']['int8_first_s'] * 1e3:.1f} ms), "
          f"{out['cpu']['int8_s'] * 1e3:.1f} ms on the CPU; compress_topk "
          f"{out['card']['topk_s'] * 1e3:.1f} ms / "
          f"{out['cpu']['topk_s'] * 1e3:.1f} ms ({card})")
    return dict(leaves=len(grads), entries=n, kept=n_kept, **out)


def reshard_check(model, loss_fn, data, opt, opt_state, step: int,
                  card: str) -> dict:
    """[train] the state after ``step`` steps saved with
    ``CheckpointManager``, restored on the host and cut by
    ``runtime.elastic.reshard_state`` onto the 1x1 grid: step ``step + 1``
    from that state must give the loss and every parameter of the same
    step taken without the round trip, bit for bit."""
    params = {k: p for k, p in model.named_parameters()}
    ckdir = ROOT / "build" / "train-ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(ckdir)
    _, t_save = wall(lambda: mgr.save(step, params, opt_state))
    like = {"params": {k: torch.empty((), dtype=p.dtype)
                       for k, p in params.items()},
            "opt": OptState(torch.empty((), dtype=opt_state.step.dtype),
                            {k: torch.empty(()) for k in opt_state.m},
                            {k: torch.empty(()) for k in opt_state.v})}
    (r_params, r_opt, at), t_restore = wall(lambda: mgr.restore(step, like))
    require(at == step, f"[train] restored step {at}, not {step}")

    def spec(x):  # rows over "data", columns over "model"
        return ("data", "model")[:x.dim()]

    grid = make_grid(1, 1)
    state = {"params": r_params, "opt": r_opt}
    specs = {"params": {k: spec(x) for k, x in r_params.items()},
             "opt": OptState((), {k: spec(x) for k, x in r_opt.m.items()},
                             {k: spec(x) for k, x in r_opt.v.items()})}
    placed, t_reshard = wall(lambda: reshard_state(state, specs, grid))
    tdist.destroy_process_group()
    shutil.rmtree(ckdir, ignore_errors=True)
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in twin.named_parameters():
            p.copy_(placed["params"][k])
    step_fn = make_train_step(loss_fn, opt)
    batch = to_device(data(step), CARD)
    _, _, m_direct = step_fn(model, opt_state, batch)
    _, _, m_round = step_fn(twin, placed["opt"], batch)
    same_loss = float(m_direct["loss"]) == float(m_round["loss"])
    twin_params = dict(twin.named_parameters())
    differ = [k for k, p in model.named_parameters()
              if not torch.equal(p, twin_params[k])]
    print(f"[train] step {step + 1} from the state saved after step {step}, "
          f"restored and resharded onto the 1x1 grid: loss "
          f"{float(m_round['loss'])!r} against {float(m_direct['loss'])!r} "
          f"without the round trip; {len(differ)} of {len(twin_params)} "
          f"parameters differ; save {t_save:.2f} s, restore {t_restore:.2f} "
          f"s, reshard {t_reshard:.2f} s ({card})")
    require(same_loss and not differ,
            f"[train] the resharded state's step differs: loss "
            f"{float(m_round['loss'])!r} vs {float(m_direct['loss'])!r}, "
            f"parameters {differ[:5]}")
    del twin, placed
    return dict(loss=float(m_round["loss"]), save_s=t_save,
                restore_s=t_restore, reshard_s=t_reshard)


def phase_train(log, kernels):
    """[train] qwen2-0.5b at full width and depth, bf16 compute, the
    flash-attention kernel under autograd (``training``), then bert4rec at
    full width; see the module docstring, 13."""
    card = log["card"]
    out = log["train"] = {}
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="bfloat16",
                              attention_impl="cuda")
    tr = TRAIN
    model = build_defs(cfg, seed=tr["seed"])
    data = train_launch._data_fn(cfg, tr["batch"], tr["seq"])
    batch0 = to_device(data(0), CARD)
    loss_fn = build_loss(cfg)
    # K5 in the forward alone, then in a whole step (remat recomputes
    # every block in backward)
    backend.reset_launch_counts()
    with torch.no_grad():
        loss_fn(model, batch0)
    sync()
    fwd = backend.launch_counts()["flash_attention"]
    require(fwd == cfg.n_layers, f"[train] K5 launches per forward {fwd}")
    # step 1's loss and gradients, kernel path against plain path
    backend.reset_launch_counts()
    (lk, _, gk), t_k = wall(lambda: loss_and_grads(loss_fn, model, batch0))
    per_step = backend.launch_counts()["flash_attention"]
    plain = dataclasses.replace(cfg, attention_impl="torch")
    (lp, _, gp), t_p = wall(lambda: loss_and_grads(build_loss(plain), model,
                                                   batch0))
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    worst, at = grad_margin(gk, gp)
    del gp
    free_card()
    out["compression"] = compression_check(gk, card)
    del gk
    free_card()
    require(rel <= TRAIN_LOSS_TOL, f"[train] step-1 loss {float(lk)!r} vs "
            f"plain {float(lp)!r}: {rel:.3g} relative")
    require(worst <= TRAIN_GRAD_TOL, f"[train] gradient {at}: {worst:.3g} "
            f"of its largest magnitude")
    print(f"[train] qwen2-0.5b bf16 B={tr['batch']} S={tr['seq']}: K5 "
          f"launches {fwd} per forward, {per_step} per step (remat "
          f"recomputes each block); step 1 loss {float(lk)!r} kernel path, "
          f"{float(lp)!r} plain ({rel:.3g} relative, bar {TRAIN_LOSS_TOL}); "
          f"worst gradient leaf {at} at {worst:.3g} of its largest magnitude "
          f"(bar {TRAIN_GRAD_TOL}); forward+backward {t_k:.3f} s kernel "
          f"path, {t_p:.3f} s plain ({card})")
    # the main path: 5 AdamW steps through training.loop.train
    opt = AdamWConfig(lr=tr["lr"], warmup_steps=max(tr["steps"] // 10, 1),
                      total_steps=tr["steps"])
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    (_, opt_state, hist), t_all = wall(lambda: train(
        model, loss_fn, data, opt, n_steps=tr["steps"], log_every=1))
    k5 = backend.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(k5 == tr["steps"] * per_step, f"[train] K5 launches {k5}")
    kernels["flash_attention"]["launches"] += k5
    with torch.no_grad():
        after = float(loss_fn(model, batch0)[0])
    losses = [h["loss"] for h in hist]
    require(after < losses[0] and all(np.isfinite(losses)),
            f"[train] loss {losses} then {after} on batch 0")
    step_s = statistics.median(h["dt"] for h in hist[1:])
    tokens = tr["batch"] * tr["seq"]
    out["reshard"] = reshard_check(model, loss_fn, data, opt, opt_state,
                                   tr["steps"], card)
    del opt_state
    free_card()
    prof = profiled(lambda: train(model, loss_fn, data, opt,
                                  n_steps=tr["steps"] + 1, log_every=100,
                                  start_step=tr["steps"]),
                    "one qwen2-0.5b train step", watch=("flash", "gemm"))
    print(f"[train] 5 AdamW steps in {t_all:.2f} s: losses {losses}, then "
          f"{after!r} on batch 0 (step 0's {losses[0]!r}); {step_s * 1e3:.1f} "
          f"ms per later step (first {hist[0]['dt'] * 1e3:.1f} ms), "
          f"{tokens / step_s:.0f} tokens/s; peak memory {peak:.2f} GiB; K5 "
          f"launches {k5}; device busy "
          f"{100 * prof['device_busy_s'] / prof['wall_s']:.1f}% of a step "
          f"({card})")
    out["qwen2"] = dict(fwd_k5=fwd, step_k5=per_step, loss_kernel=float(lk),
                        loss_plain=float(lp), loss_rel=rel, grad_worst=worst,
                        grad_worst_leaf=at, fwd_bwd_s=dict(kernel=t_k,
                                                           plain=t_p),
                        losses=losses, loss_after=after, step_s=step_s,
                        first_step_s=hist[0]["dt"], tokens_per_s=tokens
                        / step_s, peak_gib=peak, k5=k5, profile=prof)
    del model, batch0
    free_card()
    # bert4rec at full width
    rcfg = get_config("bert4rec")
    rec = build_defs(rcfg, seed=tr["seed"])
    rdata = train_launch._data_fn(rcfg, tr["rec_batch"], rcfg.seq_len)
    (_, _, rh), t_r = wall(lambda: train(
        rec, build_loss(rcfg), rdata, opt, n_steps=tr["rec_steps"],
        log_every=1))
    rl = [h["loss"] for h in rh]
    require(all(np.isfinite(rl)), f"[train] bert4rec losses {rl}")
    r_step = statistics.median(h["dt"] for h in rh[1:])
    print(f"[train] bert4rec B={tr['rec_batch']} S={rcfg.seq_len} "
          f"({count_params(rec) / 1e6:.1f}M params): {tr['rec_steps']} "
          f"steps in {t_r:.2f} s, losses {rl}; {r_step * 1e3:.1f} ms per "
          f"later step (first {rh[0]['dt'] * 1e3:.1f} ms) ({card})")
    out["bert4rec"] = dict(losses=rl, step_s=r_step,
                           first_step_s=rh[0]["dt"])
    del rec
    free_card()


def reddit_blocks(shape, seed: int):
    """graphsage's ``minibatch_lg`` batch: a host graph of Reddit's size
    (random edges, features and labels), its CSR, and blocks sampled from
    1,024 seeds (the recipe of ``tests/test_configs_smoke.py``). Returns
    (numpy ``GraphBatch``, host seconds by part)."""
    n, e, d = shape.d("n_nodes"), shape.d("n_edges"), shape.d("d_feat")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, gnn_out_dim(shape.name), n).astype(np.int32)
    t1 = time.perf_counter()
    ptr, nbrs = build_csr(n, src, dst)
    del src, dst
    t2 = time.perf_counter()
    blocks = sample_blocks(ptr, nbrs, rng.integers(0, n, shape.d(
        "batch_nodes")), [shape.d("fanout1"), shape.d("fanout2")], rng)
    batch = GraphBatch(node_feat=feats[blocks.node_ids],
                       edge_src=blocks.edge_src, edge_dst=blocks.edge_dst,
                       labels=labels[blocks.node_ids])
    t3 = time.perf_counter()
    return batch, dict(draw_s=t1 - t0, csr_s=t2 - t1, sample_s=t3 - t2)


def gnn_cell_batch(cfg, shape, seed: int):
    """The numpy batch of ``cfg``'s GNN at ``shape``, as the dry run sizes
    it, and the host seconds it took (by part for graphsage)."""
    t0 = time.perf_counter()
    if cfg.kind == "graphsage":
        return reddit_blocks(shape, seed)
    n_grid = gnn_data.sampled_sizes(shape.d("batch_nodes"), (
        shape.d("fanout1"), shape.d("fanout2")))[0]
    if cfg.kind == "graphcast":
        batch = gnn_data.random_graphcast_batch(
            n_grid, cfg.opt("n_vars", 227), seed=seed)
    else:  # the molecule cell: batch x (n_nodes, n_edges)
        b = shape.d("batch")
        batch = gnn_data.random_graph(
            shape.d("n_nodes") * b, shape.d("n_edges") * b, shape.d("d_feat"),
            seed=seed, coords=True, n_graphs=b,
            triplets=cfg.kind == "dimenet")
    return batch, dict(draw_s=time.perf_counter() - t0)


def gnn_small_batch(cfg, shape):
    """A graph of the JAX tests' sizes with the cell's features and
    classes (``tests/test_configs_smoke.py::_gnn_batch``)."""
    if cfg.kind == "graphcast":
        return gnn_data.random_graphcast_batch(120, cfg.opt("n_vars", 227))
    coords = cfg.kind in ("dimenet", "equiformer_v2")
    d = shape.d("d_feat")
    if shape.name == "molecule":
        return gnn_data.random_graph(60, 128, d, seed=0, coords=coords,
                                     n_graphs=4,
                                     triplets=cfg.kind == "dimenet")
    return gnn_data.random_graph(80, 240, d, n_classes=gnn_out_dim(
        shape.name), seed=0, coords=coords, triplets=cfg.kind == "dimenet")


def gnn_card_vs_cpu(cfg, shape) -> dict:
    """At ``GNN["check_layers"]`` layers and full width: one model drawn
    on the CPU and copied to the card, step 1's loss and gradients on a
    small graph on both; fails at the first leaf over its bar."""
    cfg2 = dataclasses.replace(cfg, n_layers=GNN["check_layers"])
    cpu = build_defs(cfg2, shape, device="cpu", seed=GNN["seed"])
    card = build_defs(cfg2, shape, seed=GNN["seed"])
    card.load_state_dict(cpu.state_dict())
    raw = gnn_small_batch(cfg2, shape)
    loss_fn = build_loss(cfg2)
    lc, _, gc_ = loss_and_grads(loss_fn, cpu, to_device(raw, "cpu"))
    lg, _, gg = loss_and_grads(loss_fn, card, to_device(raw, CARD))
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    require(rel <= GNN_LOSS_TOL, f"[gnn] {cfg.name}: card loss {float(lg)!r} "
            f"vs CPU {float(lc)!r}: {rel:.3g} relative")
    zero = near_zero_leaves(cpu) if cfg.kind == "equiformer_v2" else set()
    largest = max(float(g.abs().max()) for g in gc_.values())
    worst, at, worst_zero = 0.0, "", 0.0
    for name, want in gc_.items():  # in the model's order: the first miss
        diff = float((gg[name].cpu() - want).abs().max())
        if name in zero:
            share = diff / largest
            require(share <= GNN_ZERO_TOL, f"[gnn] {cfg.name}: gradient "
                    f"{name}: {share:.3g} of the model's largest")
            worst_zero = max(worst_zero, share)
            continue
        share = diff / max(float(want.abs().max()), 1e-30)
        require(share <= GNN_GRAD_TOL, f"[gnn] {cfg.name}: gradient {name}: "
                f"{share:.3g} of its largest magnitude (first leaf over "
                f"{GNN_GRAD_TOL})")
        if share > worst:
            worst, at = share, name
    return dict(loss_cpu=float(lc), loss_card=float(lg), loss_rel=rel,
                grad_worst=worst, grad_worst_leaf=at,
                near_zero_worst=worst_zero, near_zero_leaves=len(zero))


@torch.no_grad()
def descent(model, loss_fn, batch, loss0: float, grads: dict):
    """A plain gradient step p - eta g, with eta such that its first-order
    decrease is a share of the loss (``GNN_DESCENT``, largest first),
    must lower the loss on ``batch``. Returns (share, new loss); the
    parameters are restored."""
    params = dict(model.named_parameters())
    saved = {k: p.clone() for k, p in params.items()}
    g2 = sum(float(torch.sum(g.double() ** 2)) for g in grads.values())
    tried = []
    for share in GNN_DESCENT:
        eta = share * loss0 / g2
        for k, p in params.items():
            p.sub_(eta * grads[k])
        loss = float(loss_fn(model, batch)[0])
        for k, p in params.items():
            p.copy_(saved[k])
        tried.append(loss)
        if loss < loss0:
            return share, loss
    raise AssertionError(f"[gnn] no gradient step lowered the loss "
                         f"{loss0!r}: {tried}")


def phase_gnn(log):
    """[gnn] the GNN family at full width and depth (``models.gnn``); see
    the module docstring, 14."""
    card = log["card"]
    out = log["gnn"] = {}
    tr = GNN
    opt = AdamWConfig(lr=tr["lr"], warmup_steps=max(tr["steps"] // 10, 1),
                      total_steps=tr["steps"])
    backend.reset_launch_counts()
    for arch, cell in GNN_CELLS:
        cfg = get_config(arch)
        shape = gnn_shape(cell)
        check = gnn_card_vs_cpu(cfg, shape)
        free_card()
        raw, host = gnn_cell_batch(cfg, shape, tr["seed"])
        model = build_defs(cfg, shape, seed=tr["seed"])
        loss_fn = build_loss(cfg)
        data = lambda step: raw  # noqa: E731 — one batch, copied each step
        batch0 = to_device(raw, CARD)
        l0, _, g0 = loss_and_grads(loss_fn, model, batch0)
        require(np.isfinite(float(l0)) and all(
            bool(torch.isfinite(g).all()) for g in g0.values()),
            f"[gnn] {arch}: step 1's loss or gradient is not finite")
        share, l1 = descent(model, loss_fn, batch0, float(l0), g0)
        del g0, batch0
        free_card()
        torch.cuda.reset_peak_memory_stats()
        (_, _, hist), t_all = wall(lambda: train(
            model, loss_fn, data, opt, n_steps=tr["steps"], log_every=1))
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in hist]
        require(all(np.isfinite(losses)), f"[gnn] {arch}: losses {losses}")
        step_s = statistics.median(h["dt"] for h in hist[1:])
        prof = profiled(lambda: train(model, loss_fn, data, opt,
                                      n_steps=tr["steps"] + 1,
                                      log_every=100,
                                      start_step=tr["steps"]),
                        f"one {arch} train step")
        busy = prof["device_busy_s"] / prof["wall_s"]
        if isinstance(raw, GraphBatch):
            n_nodes, n_edges = raw.node_feat.shape[0], raw.edge_src.shape[0]
        else:
            n_nodes, n_edges = raw.grid_feat.shape[0], raw.g2m_src.shape[0] \
                + raw.mesh_src.shape[0] + raw.m2g_src.shape[0]
        host_text = ", ".join(f"{k} {v:.2f} s" for k, v in host.items())
        print(f"[gnn] {arch} ({cfg.n_layers} layers, d {cfg.d_hidden}, "
              f"{count_params(model) / 1e6:.2f}M params) on {cell}: "
              f"{n_nodes} nodes, {n_edges} edges; card vs CPU at "
              f"{tr['check_layers']} layers: loss {check['loss_rel']:.3g} "
              f"relative (bar {GNN_LOSS_TOL}), worst leaf "
              f"{check['grad_worst_leaf']} at {check['grad_worst']:.3g} (bar "
              f"{GNN_GRAD_TOL}), {check['near_zero_leaves']} near-zero "
              f"leaves within {check['near_zero_worst']:.3g} of the largest "
              f"(bar {GNN_ZERO_TOL}) ({card})")
        print(f"[gnn] {arch}: a gradient step for a {share:g} decrease took "
              f"the loss from {float(l0)!r} to {l1!r}; 5 AdamW steps in "
              f"{t_all:.2f} s: losses {losses}; {step_s * 1e3:.1f} ms per "
              f"later step (first {hist[0]['dt'] * 1e3:.1f} ms); peak "
              f"memory {peak:.2f} GiB; device busy {100 * busy:.1f}% of a "
              f"step; host data {host_text} ({card})")
        out[arch] = dict(cell=cell, n_nodes=n_nodes, n_edges=n_edges,
                         check=check, descent=dict(share=share,
                                                   loss0=float(l0),
                                                   loss1=l1),
                         losses=losses, step_s=step_s,
                         first_step_s=hist[0]["dt"], peak_gib=peak,
                         busy=busy, profile=prof, host_s=host)
        del model, raw, data
        free_card()
    launched = {k: v for k, v in backend.launch_counts().items() if v}
    require(not launched, f"[gnn] hand-written kernels launched: {launched}")


def dryrun_start():
    """The whole dry run (``--all --mesh both``) started in a child
    process, which traces on the host beside the card's phases. Its output
    goes to unnamed temporary files, so a full pipe never stalls it; a
    thread notes when it ends."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both"], cwd=ROOT, env=env, stdout=out, stderr=err,
        text=True)
    ended = []
    threading.Thread(target=lambda: (proc.wait(),
                                     ended.append(time.perf_counter())),
                     daemon=True).start()
    return dict(proc=proc, t0=t0, ended=ended, out=out, err=err)


def dryrun_stop(started) -> None:
    """Kill the dry-run child if it still runs, and close its files."""
    proc = started["proc"]
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    started["out"].close()
    started["err"].close()


def dryrun_finish(log, started) -> None:
    """Wait for the whole dry run; its 84 records must all be ok."""
    card = log["card"]
    proc = started["proc"]
    t_wait = time.perf_counter()
    proc.wait(timeout=DRYRUN["timeout_s"])
    waited_s = time.perf_counter() - t_wait
    host_s = (started["ended"][0] if started["ended"]
              else time.perf_counter()) - started["t0"]
    started["out"].seek(0)
    started["err"].seek(0)
    stdout, stderr = started["out"].read(), started["err"].read()
    require(proc.returncode == 0, f"[dryrun] --all failed "
            f"(rc {proc.returncode}): {stdout[-2000:]}{stderr[-2000:]}")
    recs = {}
    for line in stdout.splitlines():
        m = re.match(r"\[(?:OK |FAIL)\] (\S+\.json) ", line)
        if m:
            recs[m.group(1)] = json.loads(
                (dry.RESULTS / m.group(1)).read_text())
    ok = sum(1 for r in recs.values() if r.get("ok"))
    require(len(recs) == 84 and ok == 84,
            f"[dryrun] {ok} of {len(recs)} records ok, not 84 of 84")
    print(f"[dryrun] --all --mesh both: {ok}/{len(recs)} records ok, "
          f"{host_s:.1f} s of host time beside the card's phases, "
          f"{waited_s:.1f} s waited for at the end ({card})")
    rows = {}
    for r in recs.values():
        rl = r["roofline"]
        term = rl[f"{rl['dominant']}_s"]
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = \
            f"{rl['dominant']} {term * 1e3:.3f} ms"
    for (arch, shape), by_mesh in sorted(rows.items()):
        print(f"[dryrun] {arch} {shape}: single {by_mesh['single']}, "
              f"multi {by_mesh['multi']}")
    log["dryrun"]["all"] = dict(records=len(recs), ok=ok, host_s=host_s,
                                waited_s=waited_s,
                                dominant={f"{a} {s}": v for (a, s), v
                                          in rows.items()})


def dryrun_cell(arch, shape_name, cut, k5, card) -> dict:
    """One cut cell: traced on meta, then run on the card (see the module
    docstring, 15)."""
    cfg = get_config(arch)
    if cfg.family == "lm":
        cfg = dataclasses.replace(cfg, attention_impl="cuda")
    shape = next(s for s in shapes_for(cfg) if s.name == shape_name)
    shape = dataclasses.replace(shape, dims=tuple(
        (k, cut.get(k, v)) for k, v in shape.dims))
    cell = input_specs.build_cell(arch, shape_name, make_mesh(
        (1, 1), ("data", "model")), cfg_override=cfg, shape=shape)
    meta = dry.measure(cell)
    meta_peak = dry.argument_bytes(cell) + meta.temp_bytes
    args = input_specs.materialize(cell, CARD, seed=DRYRUN["seed"])
    out = cell.fn(*args)  # warm-up: cuBLAS, the allocator
    del out
    free_card()
    sync()
    resident = torch.cuda.memory_allocated()
    arg_bytes = sum(t.untyped_storage().nbytes() for _, t, _ in
                    dry.arg_leaves(args, cell.in_specs))
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launch_counts()
    on_card = dry.measure(cell, args=args)
    sync()
    launches = backend.launch_counts()
    raw_peak = torch.cuda.max_memory_allocated()
    beside = resident - arg_bytes  # workspaces and leftovers, not the step's
    card_peak = raw_peak - beside
    require(meta.flops == on_card.flops,
            f"[dryrun] {arch} {shape_name}: meta FLOPs {meta.flops!r} != "
            f"card {on_card.flops!r}")
    if k5 is not None:
        require(launches["flash_attention"] == k5,
                f"[dryrun] {arch} {shape_name}: K5 launched "
                f"{launches['flash_attention']} times, not {k5}")
    off = (meta_peak - card_peak) / card_peak
    ms = event_ms(lambda: cell.fn(*args), DRYRUN["reps"])
    rl = roofline_terms(meta.flops, meta.bytes, 0.0)
    dom_s = getattr(rl, f"{rl.dominant}_s")
    cut_text = ", ".join(f"{k} {v}" for k, v in cut.items()) or "whole"
    print(f"[dryrun] {arch} {shape_name} ({cut_text}): FLOPs meta "
          f"{meta.flops:.6e}, card {on_card.flops:.6e}, equal; peak meta "
          f"{meta_peak / 2**30:.3f} GiB (arguments "
          f"{dry.argument_bytes(cell) / 2**30:.3f} + temp "
          f"{meta.temp_bytes / 2**30:.3f}), card {card_peak / 2**30:.3f} GiB "
          f"(max_memory_allocated {raw_peak / 2**30:.3f} less "
          f"{beside / 2**20:.1f} MiB held beside the arguments), "
          f"{100 * off:+.3f}% ({'within' if abs(off) <= DRYRUN['peak_tol'] else 'MISSES'} "
          f"the {100 * DRYRUN['peak_tol']:.0f}% bar); {ms:.2f} ms a step "
          f"(median of {DRYRUN['reps']}, CUDA events) against the "
          f"dominant term, {rl.dominant}, {dom_s * 1e3:.3f} ms: "
          f"{100 * dom_s / (ms / 1e3):.1f}%; K5 launches "
          f"{launches['flash_attention']} ({card})")
    res = dict(cut=cut, flops_meta=meta.flops, flops_card=on_card.flops,
               peak_meta=meta_peak, peak_card=card_peak, peak_raw=raw_peak,
               beside=beside, peak_off=off,
               within=abs(off) <= DRYRUN["peak_tol"], ms=ms,
               dominant=rl.dominant, dominant_ms=dom_s * 1e3,
               k5=launches["flash_attention"], trace_s=meta.trace_s)
    del args, on_card, cell
    free_card()
    return res


def phase_dryrun(log, started):
    """[dryrun] the dry-run layer; see the module docstring, 15. The
    child ``started`` was started after the build."""
    card = log["card"]
    out = log["dryrun"] = {}
    t0 = time.perf_counter()
    for arch, shape_name, cut, k5 in DRYRUN["cells"]:
        out[f"{arch} {shape_name}"] = dryrun_cell(arch, shape_name, cut,
                                                  k5, card)
    dryrun_finish(log, started)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[dryrun] phase {out['phase_s']:.1f} s ({card})")


@contextlib.contextmanager
def clock(log, name: str):
    """Time one phase into ``log["phase_s"]`` and print it."""
    t0 = time.perf_counter()
    yield
    dt = log.setdefault("phase_s", {})[name] = time.perf_counter() - t0
    print(f"[time] {name} {dt:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the measurements to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {
        "awac_sweep": dict(
            name="awac_sweep", route="cuda",
            source="src/repro_torch/kernels/csrc/awac_sweep.cu",
            replaces="src/repro/kernels/cycle_gain/awac_sweep.py:121",
            library_ms=None),
        "awac_persistent": dict(
            name="awac_persistent", route="cuda",
            source="src/repro_torch/kernels/csrc/awac_persistent.cu",
            replaces="src/repro/kernels/cycle_gain/persistent.py:210",
            library_ms=None),
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
            replaces="src/repro/kernels/flash_attention/"
                     "flash_attention.py:73"),
        "router_swap": dict(
            name="router_swap", route="cuda",
            source="src/repro_torch/kernels/csrc/router_swap.cu",
            replaces="src/repro/kernels/router_swap/router_swap.py:68",
            library_ms=None),
        "embedding_bag": dict(
            name="embedding_bag", route="cuda",
            source="src/repro_torch/kernels/csrc/embedding_bag.cu",
            replaces="src/repro/kernels/embedding_bag/embedding_bag.py:50"),
        "cycle_gain": dict(
            name="cycle_gain", route="cuda",
            source="src/repro_torch/kernels/csrc/cycle_gain.cu",
            replaces="src/repro/kernels/cycle_gain/cycle_gain.py:64",
            library_ms=None),
        "mcm_persistent": dict(
            name="mcm_persistent", route="cuda",
            source="src/repro_torch/kernels/csrc/mcm_persistent.cu",
            replaces="none: plain jnp (src/repro/core/single.py mcm)",
            library_ms=None),
    }
    log = {}
    t0 = time.perf_counter()
    with clock(log, "build"):
        phase_build(log)
    dry_child = dryrun_start()  # host-only: runs beside every later phase
    try:
        with clock(log, "single"):
            single_run = phase_single(log, kernels)
        with clock(log, "batch"):
            batch_run = phase_batch(log, kernels)
        with clock(log, "dispatch"):
            phase_dispatch(log, single_run, batch_run)
        with clock(log, "grid"):
            grid = phase_grid(log, kernels, single_run, batch_run)
        with clock(log, "serve"):
            plain_stream = phase_serve(log, kernels, grid)
        with clock(log, "resilient"):
            phase_resilient(log, kernels, grid, single_run, batch_run)
        with clock(log, "chaos"):
            phase_chaos(log, kernels)
        with clock(log, "serve_resilient"):
            phase_serve_resilient(log, kernels, plain_stream)
        with clock(log, "solver"):
            phase_solver(log, kernels)
        with clock(log, "paper_eval"):
            phase_paper_eval(log, kernels)
        tdist.destroy_process_group()
        del batch_run
        with clock(log, "sweep"):
            phase_sweep(log, kernels, single_run)
        with clock(log, "profile"):
            phase_profile(log, single_run[0])
        with clock(log, "quality"):
            phase_quality(log)
        with clock(log, "lm"):
            phase_lm(log, kernels)
        with clock(log, "flash"):
            phase_flash(log, kernels)
        del single_run
        free_card()
        with clock(log, "recsys"):
            model, seqs = phase_recsys(log)
        with clock(log, "embedding_bag"):
            phase_embedding_bag(log, kernels, model, seqs)
        del model, seqs
        free_card()
        with clock(log, "cycle_gain"):
            phase_cycle_gain(log, kernels)
        with clock(log, "moe"):
            swap_inputs = phase_moe(log, kernels)  # frees the card: 57 GB
        with clock(log, "router_swap"):
            phase_router_swap(log, kernels, swap_inputs)
        del swap_inputs
        free_card()
        with clock(log, "dense_lm"):
            phase_dense_lm(log, kernels)
        with clock(log, "train"):
            phase_train(log, kernels)
        with clock(log, "gnn"):
            phase_gnn(log)
        with clock(log, "dryrun"):
            phase_dryrun(log, dry_child)
    finally:
        dryrun_stop(dry_child)
    log["total_s"] = time.perf_counter() - t0
    print(f"[done] {log['total_s']:.1f} s; card {log['card']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"log": log, "kernels": kernels},
                                       indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kv[k] for k in keys}
                                  for kv in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
