"""Synthetic graph generators for the GNN shape cells (tests, the
launcher and the chip check). Numpy copies of the JAX package's
``data/graphs.py``: one seed gives the same arrays on both sides, in a
``GraphBatch`` / ``GraphCastBatch`` of numpy arrays (``.to(device)``
makes them tensors). ``sampled_sizes`` and ``graphcast_sizes`` give the
node and edge counts of the ``minibatch_lg`` and GraphCast cells."""
from __future__ import annotations

import numpy as np

from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.graphcast import GraphCastBatch

TRIPLET_FACTOR = 8


def sampled_sizes(batch_nodes: int, fanouts):
    """Node/edge counts of a SampledBlocks batch (leaf-to-root layers)."""
    layers = [batch_nodes]
    for f in fanouts:
        layers.append(layers[-1] * f)
    layers = layers[::-1]
    n_nodes = sum(layers)
    n_edges = sum(layers[:-1])
    return n_nodes, n_edges


def graphcast_sizes(n_grid: int):
    n_mesh = max(n_grid // 16, 4)
    return {"n_mesh": n_mesh, "e_g2m": n_grid * 2, "e_mesh": n_mesh * 7,
            "e_m2g": n_grid * 3}


def random_graph(n_nodes, n_edges, d_feat, n_classes=40, seed=0, coords=False,
                 n_graphs=1, triplets=False):
    """Uniform random directed graph; optional 3D coords + DimeNet triplet
    lists (capacity TRIPLET_FACTOR * n_edges)."""
    rng = np.random.default_rng(seed)
    if n_graphs > 1:
        per = n_nodes // n_graphs
        gid = np.repeat(np.arange(n_graphs), per).astype(np.int32)
        src = (rng.integers(0, per, n_edges)
               + np.repeat(np.arange(n_graphs), n_edges // n_graphs) * per)
        dst = (rng.integers(0, per, n_edges)
               + np.repeat(np.arange(n_graphs), n_edges // n_graphs) * per)
    else:
        gid = np.zeros(n_nodes, np.int32)
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    if n_graphs > 1:
        labels = rng.normal(size=(n_graphs, 1)).astype(np.float32)
    else:
        labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    xyz = rng.normal(size=(n_nodes, 3)).astype(np.float32) if coords else None
    tri = None
    if triplets:
        cap = TRIPLET_FACTOR * n_edges
        by_dst = {}
        for e, d in enumerate(dst):
            by_dst.setdefault(int(d), []).append(e)
        kj, ji = [], []
        for e, s in enumerate(src):
            for e2 in by_dst.get(int(s), [])[:TRIPLET_FACTOR]:
                if e2 != e:
                    kj.append(e2)
                    ji.append(e)
        kj = np.array(kj[:cap] + [n_edges] * max(0, cap - len(kj)), np.int32)
        ji = np.array(ji[:cap] + [n_edges] * max(0, cap - len(ji)), np.int32)
        tri = (kj, ji)
    return GraphBatch(node_feat=feat, edge_src=src, edge_dst=dst, labels=labels,
                      coords=xyz, graph_id=gid, triplets=tri, n_graphs=n_graphs)


def random_graphcast_batch(n_grid, n_vars, seed=0):
    rng = np.random.default_rng(seed)
    sz = graphcast_sizes(n_grid)
    nm = sz["n_mesh"]
    return GraphCastBatch(
        grid_feat=rng.normal(size=(n_grid, n_vars)).astype(np.float32),
        g2m_src=rng.integers(0, n_grid, sz["e_g2m"]).astype(np.int32),
        g2m_dst=rng.integers(0, nm, sz["e_g2m"]).astype(np.int32),
        mesh_src=rng.integers(0, nm, sz["e_mesh"]).astype(np.int32),
        mesh_dst=rng.integers(0, nm, sz["e_mesh"]).astype(np.int32),
        m2g_src=rng.integers(0, nm, sz["e_m2g"]).astype(np.int32),
        m2g_dst=rng.integers(0, n_grid, sz["e_m2g"]).astype(np.int32),
        target=rng.normal(size=(n_grid, n_vars)).astype(np.float32),
        n_mesh=nm,
    )
