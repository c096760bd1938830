"""Fanout-bounded neighbor sampler (GraphSAGE-style) over CSR graphs
(twin of ``repro.data.sampler``: for a given seed, the same blocks).

Produces the fixed-shape block structure ``models.gnn.gnn_forward_sampled``
consumes: per hop, [N_k, fanout] neighbor indices into the next level's
feature rows plus a validity mask. Pure numpy — runs on the host input
pipeline.
"""
from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanouts: tuple[int, ...], seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        """Returns (node_levels, nbr_idx, nbr_valid):
        node_levels[k] — node ids at hop k (level 0 = seeds);
        nbr_idx[k]     — [len(level_k), fanout_k] indices into level k+1;
        nbr_valid[k]   — bool same shape.
        """
        levels = [np.asarray(seeds, np.int64)]
        nbr_idx, nbr_valid = [], []
        for fanout in self.fanouts:
            cur = levels[-1]
            deg = self.indptr[cur + 1] - self.indptr[cur]
            idx = np.zeros((len(cur), fanout), np.int64)
            valid = np.zeros((len(cur), fanout), bool)
            next_nodes = []
            for i, v in enumerate(cur):
                d = deg[i]
                if d == 0:
                    continue
                take = min(fanout, d)
                chosen = self.rng.choice(d, size=take, replace=d < fanout)
                nbrs = self.indices[self.indptr[v]:self.indptr[v + 1]][
                    chosen]
                idx[i, :take] = np.arange(len(next_nodes),
                                          len(next_nodes) + take)
                valid[i, :take] = True
                next_nodes.extend(nbrs.tolist())
            levels.append(np.asarray(next_nodes, np.int64))
            nbr_idx.append(idx.astype(np.int32))
            nbr_valid.append(valid)
        return levels, nbr_idx, nbr_valid

    def sample_padded(self, seeds: np.ndarray, feats: np.ndarray):
        """Fixed-shape variant: every level is padded to
        len(seeds) * prod(fanouts[:k]) rows (what the jitted step wants).
        Returns (feat_levels, nbr_idx, nbr_valid)."""
        levels, nbr_idx, nbr_valid = self.sample(seeds)
        out_feats = []
        sizes = [len(seeds)]
        for f in self.fanouts:
            sizes.append(sizes[-1] * f)
        for k, nodes in enumerate(levels):
            fl = np.zeros((sizes[k], feats.shape[1]), feats.dtype)
            fl[:len(nodes)] = feats[nodes]
            out_feats.append(fl)
        fixed_idx, fixed_valid = [], []
        for k, (idx, valid) in enumerate(zip(nbr_idx, nbr_valid)):
            fi = np.zeros((sizes[k], self.fanouts[k]), np.int32)
            fv = np.zeros((sizes[k], self.fanouts[k]), bool)
            fi[:len(idx)] = idx
            fv[:len(valid)] = valid
            fixed_idx.append(fi)
            fixed_valid.append(fv)
        return out_feats, fixed_idx, fixed_valid
