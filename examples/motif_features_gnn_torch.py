"""Where the paper's engine plugs into the model zoo, on the PyTorch port
(twin of ``examples/motif_features_gnn.py``): subgraph-motif counting as
structural features for a GCN node classifier.

For every vertex, count how many triangle / path-motif embeddings touch
it (computed exactly by the port's matcher), append these as node
features, and train the gcn-cora smoke config with the port's AdamW on a
synthetic citation-like graph. Runs on the card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/motif_features_gnn_torch.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.backtrack import backtrack_deadend
from repro_torch.core.graph import Graph
from repro_torch.data.graph_gen import ba_labeled_graph
from repro_torch.kernels.config import resolve_device
from repro_torch.models import gnn
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)

OCFG = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
STEPS = 100


def motif_counts(data: Graph, motifs: list[Graph]) -> np.ndarray:
    counts = np.zeros((data.n, len(motifs)), np.float32)
    for mi, motif in enumerate(motifs):
        res = backtrack_deadend(motif, data, limit=20000)
        for emb in res.embeddings:
            for v in emb:
                counts[v, mi] += 1.0
    return counts / np.maximum(counts.max(axis=0, keepdims=True), 1.0)


def motif_task():
    """The example's graph and inputs: (motif features [N, 2], labels
    [N] (the vertex is on a triangle), base features [N, 4] (degree,
    one-hot label), directed edge index [2, E])."""
    data = ba_labeled_graph(200, 3, 3, extra_edges=150, seed=1)
    # motifs over the same label alphabet: triangle and 3-path
    tri = Graph.from_edges(3, [(0, 1), (1, 2), (2, 0)], [0, 0, 0], 3)
    path = Graph.from_edges(3, [(0, 1), (1, 2)], [0, 1, 0], 3)
    feats = motif_counts(data, [tri, path])
    labels = (feats[:, 0] > 0).astype(np.int32)
    deg = np.asarray(data.degrees, np.float32)[:, None]
    base_x = np.concatenate([deg / deg.max(),
                             np.eye(3, dtype=np.float32)[data.labels]], 1)
    ei = np.stack([np.concatenate([data.indices,
                                   np.repeat(np.arange(data.n),
                                             data.degrees)]),
                   np.concatenate([np.repeat(np.arange(data.n),
                                             data.degrees),
                                   data.indices])]).astype(np.int32)
    return feats, labels, base_x, ei


def gnn_config(x: np.ndarray) -> gnn.GNNConfig:
    return gnn.GNNConfig(name="demo", kind="gcn", n_layers=2,
                         d_in=x.shape[1], d_hidden=16, n_classes=2)


def train(model, cfg, x, ei, labels, steps: int = STEPS,
          ocfg: AdamWConfig = OCFG):
    """``steps`` full-batch AdamW steps of ``model`` (in place) on its
    device. Returns (each step's loss as a CPU tensor, the final
    accuracy)."""
    device = next(model.parameters()).device
    x, ei, labels = (torch.from_numpy(np.asarray(a)).to(device)
                     for a in (x, ei, labels))
    params = convert.ref_order(model)
    opt = adamw_init(params, ocfg)
    losses = []
    for _ in range(steps):
        loss = gnn.gnn_loss(model, cfg, x, ei, labels)
        loss.backward()
        adamw_update(params, {n: p.grad for n, p in params.items()}, opt,
                     ocfg)
        model.zero_grad(set_to_none=True)
        losses.append(loss.detach())
    with torch.no_grad():
        pred = gnn.gnn_forward_full(model, cfg, x, ei).argmax(1)
    return torch.stack(losses).cpu(), float((pred == labels).float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    feats, labels, base_x, ei = motif_task()
    print(f"motif features: {feats.shape}, "
          f"triangles touch {int((feats[:, 0] > 0).sum())} vertices")
    # labels: whether the vertex participates in a triangle (learnable
    # from structure) — train GCN with and without motif features
    for name, x in (("plain", base_x),
                    ("plain+motif", np.concatenate([base_x, feats], 1))):
        cfg = gnn_config(x)
        model = gnn.gnn_init(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
        losses, acc = train(model, cfg, x, ei, labels)
        print(f"{name:13s}: final loss {float(losses[-1]):.4f} "
              f"acc {acc:.3f}")


if __name__ == "__main__":
    main()
