#!/usr/bin/env python3
"""Phase 15 (b)'s decode-against-prefill figures on the host CPU beside
the card's, for one model and one token stream.

    python3 scripts/lm_rule_cpu.py [--steps N] [--out PATH]

Draws qwen3-0.6b ``FULL`` (bf16, random weights) on the card from
``chip_smoke.py``'s seed, runs ``chip_smoke.lm_full_width_figures`` on
the card (4 x 256 prompt, greedy decode), then copies the same weights
to the CPU and runs the same function there, its decode fed the card's
greedy tokens. So both runs see one model and one token stream, and the
figures come from the rule code the smoke uses: each device's decode
and prefill logits against its own teacher-forced ``lm_logits``, under
the smoke's rule and under the reference's rtol = atol = 5e-2, and the
float32 anchor. Also prints the largest difference between the card's
and the CPU's decode logits. Writes the JSON to ``--out`` (default
``chiprun_out/lm_rule_cpu.json``) and prints it with the card's name
and power limit. Needs a card; checks nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as smoke
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import transformer as T
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "lm_rule_cpu.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_rule_cpu: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = ARCHS["qwen3-0.6b"].config
    model = T.lm_init(torch.Generator(device=card).manual_seed(0), cfg,
                      device=card)
    res = {"card_line": smoke.card_line(), "torch": torch.__version__,
           "cpu_threads": torch.get_num_threads()}
    t0 = time.perf_counter()
    res["card"], out = smoke.lm_full_width_figures(model, cfg, card,
                                                   steps=args.steps)
    res["card_seconds"] = time.perf_counter() - t0
    fed, dec_card = out["fed"].cpu(), out["decode"].float().cpu()
    del out
    model = model.to(cpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["cpu"], out = smoke.lm_full_width_figures(model, cfg, cpu,
                                                  steps=args.steps,
                                                  forced=fed)
    res["cpu_seconds"] = time.perf_counter() - t0
    res["cpu_fed_card_tokens"] = True
    res["card_vs_cpu_decode_max_abs_err"] = float(
        (out["decode"].float() - dec_card).abs().max())
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1, default=float))
    print(json.dumps(res, default=float))
    print(res["card_line"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
