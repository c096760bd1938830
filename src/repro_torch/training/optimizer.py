"""AdamW with global-norm clipping, cosine schedule, and a reduced-
precision state mode (twin of ``repro.training.optimizer``).

Parameters, gradients and moments are ``{name: tensor}`` mappings keyed
by ``module.named_parameters()``'s names; a gradient that is ``None``
(or missing) counts as a zero gradient, as the reference's autodiff
gives for a parameter that reaches the loss only through indices (the
MoE ``router_bias``): it adds 0 to the global norm, its moments decay,
and it keeps its state. Weight decay applies to the leaves the
reference decays, those whose leaf in its tree has two or more
dimensions: by default each tensor's own ``ndim``, or the names in
``decay`` (``convert.decayed`` gives them for a port module whose
reference tree stacks layers, where every per-layer tensor, norms and
biases included, is a slice of a stacked leaf). ``adamw_update``
writes the parameters and the moments in place under
``torch.no_grad()``, one leaf at a time as the reference's ``upd``
does, in the order of the ``params`` mapping (the global norm sums its
leaves in that order: ``convert.ref_order`` gives the reference's
flatten order).

The schedule, the bias corrections and the clip scale are float32
tensors computed from a 0-d int32 step on the parameters' device, as the
reference computes them traced under ``jit``; moment updates are
computed in float32 and rounded once a step to ``state_dtype`` (float32
by default; bfloat16 for the largest MoE configs).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac * lr (float32)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and the
    step count (a 0-d int32 tensor on the parameters' device)."""
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf of a mapping or an
    iterable of tensors, in float32, summed leaf by leaf in order;
    ``None`` leaves add nothing."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    total = None
    for leaf in leaves:
        if leaf is None:
            continue
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping, state: dict,
                 cfg: AdamWConfig, decay=None) -> tuple[Params, dict]:
    """One AdamW step, in place: every parameter of ``params`` and its
    moments in ``state`` are overwritten, ``state["step"]`` advances.
    ``decay``: the names that take weight decay (default: those with
    ``ndim >= 2``). Returns ``(params, state)``."""
    step = state["step"] + 1
    gnorm = global_norm([grads.get(n) for n in params])
    scale = torch.clamp(cfg.grad_clip / (gnorm.to(step.device) + 1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()
    for name, p in params.items():
        g, m, v = grads.get(name), state["m"][name], state["v"][name]
        gf = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              if g is None else g.float()) * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat = mf / c1
        vhat = vf / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if (p.ndim >= 2) if decay is None else (name in decay):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return params, state
