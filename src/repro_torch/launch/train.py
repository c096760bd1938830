"""End-to-end LM training driver with checkpoint/restart fault tolerance
(twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 300 --batch 8 --seq 256 --ckpt-dir /tmp/run1 --resume auto

Runs on the card unless ``--device cpu`` is given (``"cuda"`` without a
card raises). Features exercised:
  * config-driven model/optimizer construction (--arch picks the smoke or
    full config; --scale smoke|full),
  * resumable deterministic data pipeline,
  * atomic checkpointing every --ckpt-every steps + auto-resume, in the
    reference's layout (``convert.lm_tree`` / ``opt_tree``), so either
    package resumes the other's run,
  * simulated failure injection (--fail-at-step) proving restart works.

Random initialisation comes from a ``torch.Generator`` seeded 0 on the
run's device (the reference's ``jax.random.key(0)`` draws cannot be
reproduced). MoE archs train with their router bias held where it is, as
the reference's driver does: its docstring promises aux-free router-bias
balancing, but its ``main`` never calls ``update_router_bias``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import convert
from ..configs.registry import get_arch
from ..data.lm_data import LMStreamConfig, TokenStream
from ..kernels.config import resolve_device
from ..models import transformer
from ..training import checkpoint
from ..training.optimizer import AdamWConfig, adamw_init, adamw_update


def train_step(model, opt: dict, batch: dict, cfg, ocfg: AdamWConfig
               ) -> torch.Tensor:
    """One step in place: ``lm_loss`` on ``batch`` (tensors on the
    model's device), backward, ``adamw_update`` over the parameters in the
    reference's flatten order with the reference's decayed leaves
    (``convert.decayed``: every per-layer tensor), gradients cleared.
    Returns the loss (detached, on the device)."""
    loss = transformer.lm_loss(model, cfg, batch)
    loss.backward()
    params = convert.ref_order(model)
    adamw_update(params, {n: p.grad for n, p in params.items()}, opt, ocfg,
                 decay=convert.decayed(model))
    model.zero_grad(set_to_none=True)
    return loss.detach()


def restore_lm(ckpt_dir, cfg, ocfg: AdamWConfig, device):
    """The newest checkpoint in ``ckpt_dir`` as (model, optimizer state,
    step, extra) on ``device``."""
    meta = transformer.lm_init(None, cfg, device="meta")
    template = (convert.lm_tree(meta),
                convert.opt_tree(adamw_init(convert.ref_order(meta), ocfg),
                                 meta))
    (ptree, otree), step, extra = checkpoint.restore(ckpt_dir, template,
                                                     device=device)
    model = convert.lm_params(ptree, cfg, device=device)
    return model, convert.opt_state(otree, model), step, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a crash once (restart with --resume auto)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise ValueError(f"{args.arch} is a {spec.family} arch: train.py "
                         "drives LM archs; see the gnn example")
    cfg = spec.smoke_config if args.scale == "smoke" else spec.config
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20))

    gen = torch.Generator(device=dev).manual_seed(0)
    model = transformer.lm_init(gen, cfg, device=dev)
    opt = adamw_init(convert.ref_order(model), ocfg)
    stream = TokenStream(LMStreamConfig(vocab=cfg.vocab, batch=args.batch,
                                        seq_len=args.seq))
    start = 0
    if args.ckpt_dir and args.resume == "auto":
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            del model, opt
            model, opt, start, extra = restore_lm(args.ckpt_dir, cfg, ocfg,
                                                  dev)
            stream = TokenStream.from_state(stream.cfg, extra["stream"])
            print(f"[resume] restored step {start}")

    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.next_batch().items()}
        loss = train_step(model, opt, batch, cfg, ocfg)
        losses.append(float(loss))
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = (args.batch * args.seq * (step - start + 1)
                     / max(time.time() - t0, 1e-9))
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"tok/s {tok_s:,.0f}")
        if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                              or step == args.steps - 1):
            checkpoint.save(args.ckpt_dir, step + 1,
                            (convert.lm_tree(model),
                             convert.opt_tree(opt, model)),
                            extra={"stream": stream.state(),
                                   "loss": float(loss)})
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"[done] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
