"""Deterministic, resumable synthetic token pipeline (twin of
``repro.data.lm_data``: for a given seed and step, the same batches bit
for bit).

Emits document-structured token streams (Zipf unigrams + per-document
'topic' shift + EOS boundaries) packed into fixed [batch, seq] blocks.
State = (seed, step) — resuming a restarted job at step k reproduces the
exact batch sequence (the property the fault-tolerance test asserts).
Pure numpy — runs on the host input pipeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMStreamConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    eos: int = 0
    mean_doc_len: int = 256


class TokenStream:
    def __init__(self, cfg: LMStreamConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    @staticmethod
    def from_state(cfg: LMStreamConfig, state: dict) -> "TokenStream":
        return TokenStream(cfg, step=int(state["step"]))

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.step]))
        self.step += 1
        n = cfg.batch * (cfg.seq_len + 1)
        # zipf body with per-doc topic offsets
        toks = rng.zipf(1.3, size=2 * n).astype(np.int64)
        toks = toks[toks < cfg.vocab - 1][:n] + 1
        while len(toks) < n:
            extra = rng.zipf(1.3, size=n).astype(np.int64)
            extra = extra[extra < cfg.vocab - 1] + 1
            toks = np.concatenate([toks, extra])[:n]
        # sprinkle EOS at ~1/mean_doc_len rate
        eos_mask = rng.random(n) < 1.0 / cfg.mean_doc_len
        toks[eos_mask] = cfg.eos
        block = toks.reshape(cfg.batch, cfg.seq_len + 1).astype(np.int32)
        return {"tokens": block[:, :-1], "targets": block[:, 1:]}


def din_synthetic_batch(cfg, batch: int, seed: int = 0, step: int = 0):
    """Synthetic DIN batch with popularity-skewed items and correlated
    histories (items near the target id are more likely)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    L = cfg.seq_len
    target = (rng.pareto(1.2, batch) * 1000).astype(np.int64) % cfg.n_items
    drift = rng.integers(-5000, 5000, size=(batch, L))
    hist = (target[:, None] + drift) % cfg.n_items
    mask = (rng.random((batch, L)) < 0.8).astype(np.float32)
    labels = (rng.random(batch) < 0.35).astype(np.int32)
    return {
        "target_item": target.astype(np.int32),
        "target_cat": (target % cfg.n_cats).astype(np.int32),
        "hist_items": hist.astype(np.int32),
        "hist_cats": (hist % cfg.n_cats).astype(np.int32),
        "hist_mask": mask,
        "dense_feats": rng.standard_normal(
            (batch, cfg.n_dense_feats)).astype(np.float32),
        "labels": labels,
    }
