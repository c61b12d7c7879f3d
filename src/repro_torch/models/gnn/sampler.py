"""Real neighbor sampler for minibatch training (GraphSAGE-style fixed
fanout). Numpy-side (data pipeline); outputs padded, shape-static blocks.
A copy of the JAX package's ``models/gnn/sampler.py``: one seed gives the
same arrays on both sides."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SampledBlocks(NamedTuple):
    """Layered blocks, leaf-to-root. nodes[0] are the deepest sampled nodes;
    nodes[-1] are the seeds. edge lists are (src=child, dst=parent) in LOCAL
    node numbering of the concatenated node list."""

    node_ids: np.ndarray  # [N_total] global ids (with repeats; pad = -1)
    edge_src: np.ndarray  # [E] local idx into node_ids (pad = N_total)
    edge_dst: np.ndarray  # [E]
    seed_offset: int  # seeds live at node_ids[seed_offset:seed_offset+B]
    n_seeds: int


def build_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray):
    """Adjacency (incoming-neighbor) CSR: for each node, its neighbors."""
    order = np.argsort(dst, kind="stable")
    s, d = src[order], dst[order]
    counts = np.bincount(d, minlength=n_nodes)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, s


def sample_blocks(ptr, nbrs, seeds: np.ndarray, fanouts, rng) -> SampledBlocks:
    """Uniform with-replacement fanout sampling, layered (root -> leaves),
    returned leaf-to-root. Nodes with no neighbors self-loop."""
    layers = [np.asarray(seeds, np.int64)]
    for f in fanouts:
        parents = layers[-1]
        deg = ptr[parents + 1] - ptr[parents]
        # with-replacement uniform sample; degree-0 nodes self-loop
        r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(parents), f))
        child = nbrs[ptr[parents][:, None] + r]
        child = np.where(deg[:, None] > 0, child, parents[:, None])
        layers.append(child.reshape(-1))
    # local numbering: concatenate leaf-to-root
    layers = layers[::-1]
    node_ids = np.concatenate(layers)
    offsets = np.cumsum([0] + [len(x) for x in layers])
    es, ed = [], []
    # layer L (children) -> layer L+1 (parents); children of parent p are the
    # contiguous f-block at p*f in the child layer
    for li in range(len(layers) - 1):
        child_off, parent_off = offsets[li], offsets[li + 1]
        n_par = len(layers[li + 1])
        f = len(layers[li]) // n_par
        src = child_off + np.arange(n_par * f)
        dst = parent_off + np.repeat(np.arange(n_par), f)
        es.append(src)
        ed.append(dst)
    edge_src = np.concatenate(es).astype(np.int32)
    edge_dst = np.concatenate(ed).astype(np.int32)
    return SampledBlocks(node_ids.astype(np.int64), edge_src, edge_dst,
                         seed_offset=int(offsets[-2]), n_seeds=len(seeds))
