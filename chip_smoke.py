#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``), never the JAX package:

1. prints the card (``nvidia-smi``) and builds the port's four CUDA
   kernels from the sources in this checkout, one ``nvcc`` each, at the
   same time;
2. holds each kernel bit for bit against its plain PyTorch version on
   the card: the dense refine at the human-like main-path shape and at
   ragged edge cases (rows with all 64 positions active among them); the
   hierarchical refine at the scale graph's main-path shape, at chunk
   widths 1, 4, 8 and 16 (one wider than the row), at ragged edge cases,
   on a 262144-vertex graph and with 64 active hub positions a row;
3. serves five workloads through ``QueryServer(backend="engine")`` on
   the card with default knobs — 16 eight-vertex queries on the
   human-like graph (limit 1000), the trap graph (limit None), the
   corridor graph submitted twice (the second run must warm-start from
   the template cache), the trap graph with a 16-entry device stack (its
   queries must wedge and be exported to host segments), and the
   ``scale`` workload: 32 eight-vertex queries on a 65536-vertex
   power-law graph (limit 1000), which takes the hierarchical adjacency
   layout and its kernel. Every answer is checked against the sequential
   oracle, and each kernel's launch count, set to 0 before each workload
   and read after it, against that workload's megastep iterations; every
   workload must resolve the built-in knobs (tuning ``source ==
   "builtin"``: no tuning record is committed, and a stray
   ``TUNING_CACHE_TORCH.json`` fails the run rather than move them);
4. serves the same workloads with the plain refines on the card and
   requires identical embeddings and per-query counters. This run goes
   in a second process, started right after the build: both runs are
   bound by the host issuing small eager ops, so they overlap on two CPU
   cores and the card (busy a few per cent) is no bottleneck;
5. holds the hierarchical kernel against the dense kernel on the dense
   bitmap of the same 65536-vertex graph, on refine inputs captured from
   the scale run;
6. times each kernel and its plain version on inputs captured from its
   run (human-like for the dense, scale for the hierarchical), beside
   the bound of those inputs and the launch floor (``launch_floor_ms``:
   a one-element ``zero_()`` timed the same way); the hierarchical
   kernel's line also gives the work of an average call (``per_call``:
   live rows, walked positions, live chunk reads, distinct live chunks,
   bytes of its bound);
7. profiles a short window of human-like and of scale dispatches
   (kernel launches per iteration, the device's busy share);
8. drives the kernel-op layer (``repro_torch.kernels.ops``) once, each
   kernel's launch count set to 0 before and read after:
   ``bitmap_spmm_op`` in f32 and bf16 on (a) the human-like graph's
   packed adjacency times [4704, 128], (b) a Cora-shaped graph (2708
   nodes, 10556 directed edges) times [2720, 1433], (c) the scale
   graph's 536,870,912-byte dense bitmap times [65536, 128], and (d)
   edge cases (N 1, M 32, D 1, D 129, density 0.3, words with bit 31
   set, rows of 2101 words with ~2000 set bits at D 64 and 300); SpMM's
   launches are also counted by route (``SPMM_ROUTES``): ``split``,
   ``stream`` and ``wide`` must each launch; ``flash_attention_op`` at Qwen3-0.6B's
   attention geometry (H 16,
   Hkv 8, D 128) on (a) a causal 4096-token prefill in bf16 and f32, (b)
   a 32768-token non-causal decode step of batch 4 in bf16 and f32, and (c)
   edge cases (D 16, 64, 256; group 1 and 8; causal with S < Skv, the
   mask top-left aligned; a batch-1 decode step, the most key splits;
   S 8 with group 8, the most rows per kv head; bf16 prefill at D 64 and
   D 256), blocks that do not divide S or Skv having to raise; and the
   three refine ops once each. Attention's launches are also counted by
   route (``FLASH_ROUTES``): ``split``, ``tc`` and ``fma`` must each
   launch;
9. holds every op output against its plain version on the card (SpMM
   within 1e-5 in f32 and 2e-2 in bf16; attention within 2e-4 in f32
   and, in bf16, rtol 2e-2 with an atol of two bf16 units of each
   output row's largest value; refines bit for bit);
10. times SpMM (a)-(c) and attention (a)-(b): the kernel, its plain
    version, the bound, and the library call computing the same
    function (``torch.sparse.mm`` on the CSR, ``scaled_dot_product_
    attention``), and for SpMM the bytes its gathers move through L2
    (nnz * D * element size); each case must take its route (SpMM
    human-like ``split``, Cora-shaped ``wide``, scale ``stream``; attention
    decode ``split``, bf16 prefill ``tc``, f32 prefill ``fma``);
11. serves the first four human queries of step 3 through one
    ``QueryServer`` under one ``FaultPlan``: a retried dispatch
    exception, one that exhausts the retries and demotes its queries, a
    dispatch hang, a corrupt and an overflowing digest aimed at one slot
    each, a dropped pattern flush and a failed admission (the fourth
    query's). Every spec must fire; the failed admission ends
    ``error``; every other query ends ``ok`` or ``limit`` with valid,
    distinct rows, as many as the oracle allows under the limit, and
    step 3's set where step 3 finished under the limit; the demoted ones
    carry ``stats.fallback``; the ``hangs``, ``quarantined``,
    ``fallbacks``, ``flush_drops`` and ``admission_failures`` counters
    are each at least 1, and the dense refine launched. Then a corrupt
    digest aimed at slot 0 alone, beside a fault-free run of the same
    batch (both with the deep schedule pinned, so the shared
    adaptive-depth EMA cannot couple the slots): every other query's
    rows and counters must be identical;
12. drives ``DistributedMatcher`` on the card: (a) the two human queries
    step 3 finished under the limit with the fewest rows, 4 shards and a
    checkpoint directory, each equal to step 3's set; (b) the larger of
    them losing a shard at its second wave (``micro_checkpoint_every=1``):
    it must end on 3 shards with (a)'s set; (c) the same query cut by
    ``max_rows`` at half (a)'s rows and resumed from its mid-run
    checkpoint on 2 shards, equal to (a); (d) the scale query of step 3
    with the fewest rows among those that found any, 4 shards: the hier
    layout and kernel, and step 3's count of valid, distinct rows.

13. runs the port's autotuner (``repro_torch.tuning.autotune``, smoke
    domains, backend ``cuda``, 2 trials a point) at the serving smoke
    shape (128 vertices, 8 four-vertex queries) into a temporary cache
    file: the six points must give one embedding digest; a knob-free
    ``WaveScheduler`` on that graph, pointed at the file
    (``REPRO_TORCH_TUNING_CACHE``), must resolve ``source ==
    "tuning-cache"`` under the key ``cuda/<device kind>/v128``, take the
    record's knobs and give the tuner's digest. Prints every point's
    qps, ``refine_microbench_ms``, the dense refine launches of the
    sweep, and ``TunableSpace("cuda", ...)``'s dense and hier verdicts at
    4674, 65536 and 262144 vertices (the evidence for the dense/hier
    threshold);
14. starts ``python -m repro_torch.server.launch`` on the card over the
    scale graph (two tenants, ``alpha`` weight 2 and ``beta`` weight 1,
    default engine knobs, ``--time-budget-s 600``, a default per-query
    limit of 10 for its warmup ladder) and streams, each request asking
    for limit 1000, over the
    port's ``ServeClient`` and concurrently across the tenants, the 8
    scale queries step 3 ran with the fewest rows: each query step 3
    finished under the limit must stream step 3's set, each cut at the
    limit 1000 valid, distinct rows; TTFE must be below latency;
    ``/slo`` and ``/metrics`` must answer, the engine's tuning (from
    ``/metrics``) must be the built-in knobs; the hier refine's launches
    for the streamed queries (the difference of two ``/metrics``
    snapshots) must be positive and the dense refine's 0; SIGTERM must
    drain the server to exit code 0. Prints the READY line's
    ``warmup_s`` and ``baseline_qps``, wire qps, p50 / p99 latency and
    TTFE, rows and chunks streamed, and the launches.

15. runs the model zoo (``repro_torch.models``) on the card, TF32 off,
    within 150 s: (a) every arch of the registry but the matcher at its
    smoke config in float32, one set of weights drawn on the CPU and
    copied to the card, the same inputs on both (an LM's logits, loss
    and 8 decode steps; a GNN's full and sampled forward; a potential's
    energy and forces; DIN's forward and candidate scores), the card's
    outputs within rtol 1e-4, atol 1e-5 of the CPU's (forces 1e-3 /
    1e-5); (b) qwen3-0.6b whole at its published widths (bf16, random
    weights drawn on the card): a 4 x 256 prefill through
    ``lm_decode_step`` (timed after a warm-up at that shape), 32 greedy
    decode steps, every prefill and decode logit within rtol 5e-2, atol
    4 bf16 units of the largest |logit| (at least 5e-2) of ``lm_logits``
    teacher-forced on the same 288 tokens, and the decode logits no
    further from a float32 copy's teacher-forced logits than twice the
    bf16 forward's distance from them (the lanes past the reference's
    own 5e-2 are printed); prefill ms, decode ms a step of 4 tokens and
    tokens/s printed; (c)
    deepseek-v3-671b at every published width with its depth cut to one
    layer (and the MTP block): logits, loss and 8 decode steps finite on
    2 x 64 tokens, layer 0's router load summing to 1, the share of
    pairs dropped at capacity 1.25 printed (with the share of the input
    energy in its token mean, and the share dropped once that mean is
    removed), peak allocation under 70 GB;
    (d) gcn-cora and gin-tu on a Cora-shaped graph (2708 nodes, 10556
    directed edges), nequip and mace on the molecule cell (128 graphs x
    30 atoms, 64 directed edges each; energy and forces), DIN at
    ``serve_p99`` (batch 512) with its 100M-row item table, each at its
    ``FULL`` config: finite, timed; every kernel's launch count set to
    0 before (a) and read after (d) must be 0 (the models call no
    kernel); (e) the port's kernels on inputs the models made, launch
    counts set to 0 before: ``flash_attention_op`` on (b)'s layer-0 q /
    k / v against that layer's ``_sdpa`` (the bf16 attention rule of
    step 9),
    ``bitmap_spmm_op`` on the Cora-shaped graph's packed adjacency
    against gin-tu's ``_aggregate`` of its first two layers (1e-5).

16. runs the training path (``repro_torch.training``,
    ``repro_torch.launch.train``, ``repro_torch.data.lm_data``) on the
    card, TF32 off, within 180 s, every kernel's launch count set to 0
    before it and required to be 0 after it (training runs no kernel):
    (a) every LM arch of the registry at its smoke config in float32,
    one set of weights drawn on the CPU and copied to the card, 5 calls
    of ``train_step`` on each, on the same 5 ``TokenStream`` batches (2 x
    32): every step's loss within rtol 1e-4 of the CPU's, and the final
    weights within the sign-flip rule (``adam_rule``: a lane agrees
    within rtol 1e-5, atol 1e-6, or differs by at most ``2 * sum(lr) *
    (1.2 + wd * |w|)``, AdamW's largest two-sided move, on at most 1
    lane in 1000); the motif GCN of
    ``examples/motif_features_gnn_torch.py`` the same way for 100 steps;
    (b) qwen3-0.6b whole at its published widths (bf16 weights, f32
    moments) through ``repro_torch.launch.train.main`` at batch 8 x 512
    for 20 steps, checkpoints every 10 in a temporary directory: a run
    that crashes at step 15 (``--fail-at-step``), then a run that
    resumes from step 10 and ends at 20. Every loss finite, the last 5
    losses' mean at least ``LOSS_DROP_MIN`` below the first, the newest
    checkpoint step 20, and the step-10 checkpoint restoring bit for
    bit onto the card (weights and both moments against the tensors the
    driver saved). Prints ms a step (median after the first two, CUDA
    events), tokens/s, ``adamw_update``'s share of a step, checkpoint
    bytes, save and restore seconds, peak allocated bytes, and the
    largest difference between the two runs' losses at steps 10-14 (not
    0 in general on the card: the backward's scatter-adds may run in
    another order); (c) the qwen3 smoke checkpoint written from (a)'s
    card run restoring through the port's ``restore`` onto the card bit
    for bit. ``[train-*]`` lines.

17. runs the serving examples and the step cells on the card within
    150 s, every kernel's count set to 0 before (a) and read after (b)
    (the dense refine's must be positive): (a)
    ``examples/quickstart_torch.py`` whole (the wave engine's trap(100)
    embeddings the oracle's set) and ``examples/serve_queries_torch.py``
    at its defaults but 30 of its 50 ten-vertex queries (and the heavy
    query on the
    yeast-like graph, 2 s budgets: a finished query gives the oracle's
    set, a capped one 1000 valid distinct rows, a timed-out one valid
    rows, counted; the streamed trap(60) query the oracle's set, the
    cancelled one ``cancelled`` with valid rows; the distributed
    trap(120) the oracle's set), then its ``--server`` part (8 queries)
    against ``python -m repro_torch.server.launch`` on the card (default
    graph and knobs; its dense refine launches, from ``/metrics``,
    positive; SIGTERM exit 0); (b) over a one-rank NCCL group, every cell
    of ``all_cells(include_matcher=True)`` built at mesh (1, 1) and its
    argument bytes printed; the two matcher cells at their published
    shapes on real banks (a 4096-vertex power-law graph, 16 five-vertex
    queries; ``steps.matcher_args``; the megastep cell's Δ store is the
    wave cell's input), each bit for bit against the same cell on the
    CPU, dense refine launches positive, step times; the GNN,
    equivariant and DIN cells whose estimated peak (argument bytes, a
    train step's gradients and AdamW temporaries, and 16 times what a
    probe at 1/16 of the cell's sizes allocates) is under 60 GB, run
    with random inputs, finite, and against the CPU by the f32 rule
    where the card's peak is at most 8 GB; the others listed with their
    bytes. ``[examples-*]`` and ``[cells-*]`` lines;
18. runs the models' mesh paths, the LM step cells at mesh (1, 1) over a
    one-rank NCCL group (every collective a one-rank collective), within
    90 s, every kernel's count set to 0 before and read after (each must
    stay 0: the reference's models are plain jnp): qwen3-0.6b's four
    cells at full width, all 28 layers (``train_4k`` at 2 x 4096,
    ``prefill_32k`` at 1 x 8192, ``decode_32k`` at batch 4 with its
    32768-position cache, ``long_500k`` with a 131072-position cache),
    each against the port's local path on the same arguments (the loss
    within rtol 1e-4, logits within 2 bf16 units of the largest);
    deepseek-v3-671b at full width cut to one layer (+ MTP):
    ``prefill_32k`` at 1 x 4096 and ``decode_32k`` at batch 32 (the
    ``_moe_shard_map`` path with 256 experts on one rank; MLA
    flash-decoding), and ``train_4k`` at 1 x 2048 with the experts cut to
    the largest count whose estimated bytes fit 70 GB (the only cut of
    width); every output finite; the deepseek smoke cells in float32 on
    the card against the same cells on the CPU (a second process,
    ``--mesh-cpu-run``) by the f32 rule. Each cell's bytes are reckoned
    before it runs; ms of a second call, peak bytes and, for deepseek,
    the share of (token, expert) pairs dropped at capacity are printed.
    ``[mesh-*]`` lines.

Steps 11-12 print their seconds (together, ``faults-distributed``),
refine launches (each part's count set to 0 just before it), fault
counters and fired faults; steps 13-14 theirs (``tuner-server``); step
15 one ``[models-*]`` line a part and its seconds (``models``), step 16
its ``[train-*]`` lines and its seconds (``train``), step 17 its
``[examples-*]`` / ``[cells-*]`` lines and its seconds (``slice8``),
step 18 its ``[mesh-*]`` lines and its seconds (``slice9``).
The kernel table's rows carry step 15's launches: (a)-(d)'s
(``slice6_path_launches``, each 0) and (e)'s
(``slice6_check_launches``); step 16's (``slice7_path_launches``, each
0); step 17's (``slice8_path_launches``); and step 18's
(``slice9_path_launches``, each 0).

Prints one ``[phase]`` info line per step (the ``done`` line gives the
script's own seconds), then the kernel table as one JSON line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failure, a missing CUDA device or
a checkout without ``src/repro_torch`` exits non-zero without that line.
"""
from __future__ import annotations

import gc
import json
import math
import pickle
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate (same)
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
N_SAMPLES = 128                 # refine calls kept from each captured run
N_TIMED_HIER = 32               # of those, timed for the hier kernel
TIMING_REPS = 20


class SmokeFailure(RuntimeError):
    pass


def info(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=float), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------
# phase 1: device and build
# ----------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0 and out.stdout.strip(),
            f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    out = {"wall_s": time.perf_counter() - t0}
    for name, (_, secs, log) in built.items():
        out[name] = {"build_s": secs,
                     "ptxas": [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln
                               or "smem" in ln]}
    return out


# ----------------------------------------------------------------------
# phase 2: kernel against its plain version
# ----------------------------------------------------------------------
def refine_inputs(rng, v: int, w: int, f: int, n_pos: int,
                  max_depth: int):
    """Frontier rows as the megastep builds them: positions below a
    per-row depth hold data vertices, the rest -1; ``active`` marks a
    random subset of the mapped positions."""
    import numpy as np
    depth = rng.integers(1, max_depth + 1, f)
    frontier = rng.integers(0, v, (f, n_pos)).astype(np.int32)
    below = np.arange(n_pos)[None, :] < depth[:, None]
    frontier[~below] = -1
    active = (below & (rng.random((f, n_pos)) < 0.5)).astype(np.int32)
    cand = rng.integers(-2**31, 2**31, (f, w),
                        dtype=np.int64).astype(np.int32)
    return cand, frontier, active


def kernel_cases(adj_human):
    """(name, adj, cand, frontier, active) numpy cases: the main-path
    shape and the ragged edges."""
    import numpy as np
    rng = np.random.default_rng(11)
    cases = []
    cases.append(("main F512 W147 NP64", adj_human,
                  *refine_inputs(rng, *adj_human.shape, 512, 64, 8)))
    for v, f in ((33, 1), (1000, 7), (4674, 333), (97, 1031)):
        w = (v + 31) // 32
        adj = rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
        adj = (adj | rng.integers(-2**31, 2**31, (v, w), dtype=np.int64)
               ).astype(np.int32)            # dense bits: ANDs stay live
        cases.append((f"ragged F{f} W{w}",
                       adj, *refine_inputs(rng, *adj.shape, f, 64, 12)))
    name, adj, cand, fr, act = cases[1 + 2]
    act = act.copy()
    act[::3] = 0
    cases.append(("rows with no active position", adj, cand, fr, act))
    fr = fr.copy()
    act = np.ones_like(act)
    fr[:, ::2] = -1
    cases.append(("active frontier == -1 lanes", adj, cand, fr, act))
    fr = fr.copy()
    fr[:, 1::4] = adj.shape[0] + 5
    cases.append(("frontier past V (clamped)", adj, cand, fr, act))
    fr = rng.integers(0, adj.shape[0], fr.shape).astype(np.int32)
    cases.append(("all 64 positions active", adj, cand, fr,
                  np.ones_like(fr)))
    return cases


def check_kernel(dev, cases) -> int:
    """Kernel against plain version, ``torch.equal`` (bit-exact: the
    function is integer AND, no tolerance). Returns the max abs error."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows
    from repro_torch.kernels.ref import refine_bitmap_rows_ref
    worst = 0
    for name, adj, cand, fr, act in cases:
        t = [torch.from_numpy(a).to(dev) for a in (adj, cand, fr, act)]
        got = refine_bitmap_rows(*t)
        want = refine_bitmap_rows_ref(*t)
        torch.cuda.synchronize() if dev.type == "cuda" else None
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst = max(worst, err)
        require(torch.equal(got, want), f"kernel != plain on {name}")
        info("kernel-check", case=name, shape=list(cand.shape), equal=True)
    return worst


def hier_lanes(hb) -> list:
    """The two-level layout's device lanes as int32 numpy arrays."""
    return [hb.summary.view("int32"), hb.chunk_ptr, hb.chunk_id,
            hb.chunk_data.view("int32")]


def random_hier(rng, v: int, cw: int):
    """Two-level layout of a random symmetric graph with ``v`` vertices."""
    import numpy as np
    from repro_torch.core.graph import build_hier_bitmap
    dense = rng.random((v, v)) < 0.2
    dense |= dense.T
    indptr = np.concatenate(([0], np.cumsum(dense.sum(axis=1))))
    return build_hier_bitmap(v, indptr, np.nonzero(dense)[1],
                             chunk_words=cw)


def hier_case(rng, name, hb, f, n_pos=64, max_depth=8, hubs=0):
    """(name, lanes, kmax, cand, frontier, active): refine inputs as the
    megastep builds them; ``hubs`` > 0 puts a vertex below ``hubs`` (the
    degree-sorted hubs) at position 0 of every other row, so rows stay
    live through many chunks."""
    v = hb.summary.shape[0]
    cand, frontier, active = refine_inputs(rng, v, (v + 31) // 32, f,
                                           n_pos, max_depth)
    if hubs:
        frontier[::2, 0] = rng.integers(0, hubs, frontier[::2].shape[0])
        active[::2, 0] = 1
    return (name, hier_lanes(hb), hb.kmax, cand, frontier, active)


def hier_cases(scale_graph, big_n: int = 262144):
    """The hierarchical kernel's cases: the scale graph's main-path shape,
    chunk widths 1 / 4 / 8 / 16 (16 wider than a 2-word row), ragged F,
    rows with no active position, ``frontier == -1`` and past-V lanes,
    all-dead summary rows, and a ``big_n``-vertex power-law graph."""
    import numpy as np
    from repro_torch.data.graph_gen import powerlaw_graph
    rng = np.random.default_rng(12)
    hb = scale_graph.hier_bitmap(8)
    cases = [hier_case(rng, f"scale F512 W{(scale_graph.n + 31) // 32} "
                       f"SW{hb.summary.shape[1]} C8", hb, 512, hubs=64)]
    for v, cw, f in ((300, 1, 37), (300, 4, 37), (300, 8, 37),
                     (64, 16, 5), (1000, 4, 1), (1000, 8, 1031)):
        cases.append(hier_case(rng, f"C{cw} V{v} F{f}", random_hier(
            rng, v, cw), f, max_depth=12))
    name, lanes, kmax, cand, fr, act = hier_case(
        rng, "", random_hier(rng, 520, 4), 333, max_depth=12)
    act = act.copy()
    act[::3] = 0
    cases.append(("rows with no active position", lanes, kmax, cand, fr,
                  act))
    fr, act = fr.copy(), np.ones_like(act)
    fr[:, ::2] = -1
    cases.append(("active frontier == -1 lanes", lanes, kmax, cand, fr, act))
    fr, act = fr.copy(), act.copy()
    fr[1::2, 1::4] = 520 + 5
    act[1::4, 2:] = 0           # rows whose only active position is past V
    cases.append(("frontier past V", lanes, kmax, cand, fr, act))
    # all-dead summaries: cand lives only in a chunk the row's one active
    # vertex has no neighbour in (or cand is all zero)
    summary = lanes[0].view("uint32")
    cand, fr, act = cand.copy(), fr.copy(), np.zeros_like(act)
    fr[:, 0] = rng.integers(0, 520, fr.shape[0])
    act[:, 0] = 1
    n_chunks = (cand.shape[1] + 3) // 4
    for i in range(0, cand.shape[0], 2):
        dead = [c for c in range(n_chunks)
                if not (summary[fr[i, 0], 0] >> np.uint32(c)) & 1]
        cand[i] = 0
        if dead and i % 4 == 0:
            cand[i, 4 * dead[0]:4 * dead[0] + 4] = -1
    cases.append(("all-dead summary rows", lanes, kmax, cand, fr, act))
    big = powerlaw_graph(big_n, 3, 16, seed=0).hier_bitmap(8)
    cases.append(hier_case(
        rng, f"V{big_n} F512 W{(big_n + 31) // 32} "
        f"SW{big.summary.shape[1]} C8", big, 512, hubs=64))
    cand, _, _ = refine_inputs(rng, scale_graph.n,
                               (scale_graph.n + 31) // 32, 64, 64, 8)
    fr = rng.integers(0, 16, (64, 64)).astype(np.int32)    # the hubs
    cases.append(("scale, 64 active hub positions", hier_lanes(hb), hb.kmax,
                  cand, fr, np.ones_like(fr)))
    return cases


def check_hier_kernel(dev, cases) -> int:
    """Hierarchical kernel against its plain version, ``torch.equal``
    (bit-exact: integer AND and OR, no tolerance). Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows_hier
    from repro_torch.kernels.ref import refine_bitmap_rows_hier_ref
    worst = 0
    for name, lanes, kmax, cand, fr, act in cases:
        lt = [torch.from_numpy(a).to(dev) for a in lanes]
        rt = [torch.from_numpy(a).to(dev) for a in (cand, fr, act)]
        got = refine_bitmap_rows_hier(*lt, kmax, *rt)
        want = refine_bitmap_rows_hier_ref(*lt, kmax, *rt)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst = max(worst, err)
        require(torch.equal(got, want), f"hier kernel != plain on {name}")
        info("hier-kernel-check", case=name, shape=list(cand.shape),
             chunk_words=int(lanes[3].shape[1]), kmax=kmax,
             zero_rows=int((got == 0).all(dim=1).sum()), equal=True)
    return worst


# ----------------------------------------------------------------------
# phases 3/4: the serving path end to end
# ----------------------------------------------------------------------
# name -> knobs; human and scale keep the default limit (1000)
KNOBS = {"human": {}, "trap": {"limit": None}, "corridor": {"limit": None},
         "wedge": {"limit": None, "stack_capacity": 16}, "scale": {}}
LIMITED = ("human", "scale")


def workloads():
    from repro_torch.data.graph_gen import (corridor_graph,
                                            human_like_graph, powerlaw_graph,
                                            query_set, trap_graph)
    human = human_like_graph(seed=0)
    trap_q, trap_d = trap_graph(n_b=64, n_c=64)
    corr_q, corr_d = corridor_graph()
    scale = powerlaw_graph(65536, 3, 16, seed=0)
    return {"human": (human, query_set(human, 8, 16, seed=7)),
            "trap": (trap_d, [trap_q] * 8),
            "corridor": (corr_d, [corr_q, corr_q]),
            "wedge": (trap_d, [trap_q] * 2),
            "scale": (scale, query_set(scale, 8, 32, seed=7))}


def valid_embedding(e, query, data) -> bool:
    e = [int(x) for x in e]
    if len(set(e)) != query.n:
        return False
    if any(data.labels[e[u]] != query.labels[u] for u in range(query.n)):
        return False
    return all(data.has_edge(e[u], e[int(w)])
               for u in range(query.n) for w in query.neighbors(u))


def emb_set(embs) -> set:
    return {tuple(int(x) for x in e) for e in embs}


def refine_launches() -> dict:
    from repro_torch.kernels import bitmap_refine
    return {"dense": bitmap_refine.LAUNCHES,
            "hier": bitmap_refine.HIER_LAUNCHES}


def reset_refine_launches() -> None:
    from repro_torch.kernels import bitmap_refine
    bitmap_refine.LAUNCHES = 0
    bitmap_refine.HIER_LAUNCHES = 0


def check_rows(tag: str, query, data, embs, want_n: int,
               want=None) -> None:
    """Rows valid and distinct, ``want_n`` of them, and the set ``want``
    when given."""
    require(all(valid_embedding(e, query, data) for e in embs),
            f"{tag}: invalid embedding row")
    require(len(emb_set(embs)) == len(embs), f"{tag}: duplicate embedding")
    require(len(embs) == want_n,
            f"{tag}: {len(embs)} embeddings, expected {want_n}")
    if want is not None:
        require(emb_set(embs) == want, f"{tag}: embedding set differs")


def serve(dev, wl, capture=None) -> dict:
    """Run the workloads through the port's QueryServer on ``dev``. Each
    kernel's launch count is set to 0 just before a workload and read
    just after it. ``capture`` maps a workload to ``(engine_step
    attribute, wrapper)``: the wrapper records that run's refine inputs
    (it copies them and launches no kernel). Returns per-workload
    results and scheduler figures."""
    import torch
    from repro_torch.core import engine_step
    from repro_torch.serving import QueryServer

    out = {}
    for name, (data, queries) in wl.items():
        srv = QueryServer(data, backend="engine", device=dev, **KNOBS[name])
        attr, wrap = (capture or {}).get(name, (None, None))
        real = getattr(engine_step, attr) if attr else None
        if attr:
            setattr(engine_step, attr, wrap(real))
        try:
            reset_refine_launches()
            t0 = time.perf_counter()
            if name == "corridor":
                res = [srv.submit(i, q) for i, q in enumerate(queries)]
            else:
                res = srv.submit_batch(queries)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = refine_launches()
        finally:
            if attr:
                setattr(engine_step, attr, real)
        sched = srv.scheduler
        # no tuning record is committed: every serving run keeps the
        # built-in knobs (a stray TUNING_CACHE_TORCH.json would move them)
        require(sched.tuning_record["source"] == "builtin",
                f"{name}: knobs from the tuning record "
                f"{sched.tuning_record['record']}, expected the built-ins")
        out[name] = {"results": res, "wall_s": wall,
                     "tuning": sched.tuning_record["source"],
                     "slo": srv.slo_report(), "launches": launches,
                     "variant": sched.adjacency_variant,
                     "iterations": sched.timing["iterations"],
                     "readback_s": sched.timing["readback_s"],
                     "readbacks": sched.timing["readbacks"],
                     "dispatches": sched.n_dispatches,
                     "dispatch_s": sched.t_dispatch_s,
                     "exports": sched.n_exported}
    return out


def check_launches(run) -> dict:
    """Each workload went through the kernel of its layout, once per
    megastep iteration, and never through the other one."""
    for name, r in run.items():
        want = "hier" if name == "scale" else "dense"
        other = "dense" if want == "hier" else "hier"
        require(r["variant"] == ("hier-hbm" if want == "hier"
                                 else "dense-vmem"),
                f"{name}: adjacency layout {r['variant']}")
        require(r["launches"][want] > 0, f"{name}: the {want} refine "
                "kernel was never launched")
        require(r["launches"][want] == r["iterations"],
                f"{name}: {want} refine launches {r['launches'][want]} != "
                f"megastep iterations {r['iterations']}")
        require(r["launches"][other] == 0,
                f"{name}: {r['launches'][other]} {other} refine launches")
    return {k: sum(r["launches"][k] for r in run.values())
            for k in ("dense", "hier")}


def check_answers(run, wl) -> None:
    from repro_torch.core.backtrack import backtrack_deadend
    for name in LIMITED:
        data, queries = wl[name]
        for i, (q, r) in enumerate(zip(queries, run[name]["results"])):
            require(r.status in ("ok", "limit"), f"{name} q{i}: {r.status}")
            check_rows(f"{name} q{i}", q, data, r.embeddings, len(
                backtrack_deadend(q, data, limit=1000).embeddings))
    for name in ("trap", "corridor", "wedge"):
        data, queries = wl[name]
        oracle = emb_set(backtrack_deadend(queries[0], data,
                                           limit=None).embeddings)
        for i, r in enumerate(run[name]["results"]):
            require(r.status == "ok", f"{name} q{i}: {r.status}")
            require(emb_set(r.embeddings) == oracle,
                    f"{name} q{i}: embedding set differs from the oracle")
    require(sum(r.stats.deadend_prunes
                for r in run["trap"]["results"]) > 0, "trap: no prunes")
    require(bool(run["corridor"]["results"][1].stats.cache_hit),
            "corridor: the second run did not hit the template cache")
    require(run["wedge"]["exports"] >= 1,
            "wedge: no device stack was exported to host segments")


def run_digest(run) -> dict:
    """What the kernel and plain runs must agree on, per workload and
    query: embedding set and the prune / row / store counters."""
    return {name: [(sorted(emb_set(r.embeddings)),
                    {k: int(getattr(r.stats, k)) for k in
                     ("deadend_prunes", "rows_created", "patterns_stored")})
                   for r in w["results"]]
            for name, w in run.items()}


def same_runs(a: dict, b: dict) -> None:
    require(a.keys() == b.keys(), "kernel and plain runs: workloads differ")
    for name in a:
        require(len(a[name]) == len(b[name]), f"{name}: query counts differ")
        for i, ((ea, ca), (eb, cb)) in enumerate(zip(a[name], b[name])):
            require(ea == eb, f"{name} q{i}: kernel and plain runs differ")
            for k in ca:
                require(ca[k] == cb[k], f"{name} q{i}: {k} differs between "
                        "kernel and plain runs")


def run_summary(run) -> dict:
    """Per-workload figures: wall time, qps, latency, dispatches and
    iterations."""
    out = {}
    for name, w in run.items():
        slo = w["slo"]
        out[name] = {
            "queries": len(w["results"]), "wall_s": w["wall_s"],
            "qps": len(w["results"]) / w["wall_s"],
            "p50_ms": slo["p50_ms"], "p99_ms": slo["p99_ms"],
            "dispatches": w["dispatches"],
            "mean_dispatch_ms": 1e3 * w["dispatch_s"] / max(
                1, w["dispatches"]),
            "loop_iterations": w["iterations"],
            "wall_ms_per_iteration": 1e3 * w["wall_s"] / max(
                1, w["iterations"]),
            "wedge_exports": w["exports"], "readbacks": w["readbacks"],
            "readback_share": w["readback_s"] / w["wall_s"],
            "found": sum(len(r.embeddings) for r in w["results"]),
            "prunes": sum(r.stats.deadend_prunes for r in w["results"]),
            "launches": w["launches"], "variant": w["variant"],
            "tuning": w["tuning"]}
        if name == "scale":
            out[name]["adjacency_bytes"] = slo["adjacency_bytes"]
            out[name]["chunk_words"] = slo["chunk_words"]
    return out


# ----------------------------------------------------------------------
# phases 5/6: captured main-path inputs — hier against dense, timing
# ----------------------------------------------------------------------
def sampler(samples: list, n_copied: int):
    """Wrap a refine function so it keeps a uniform sample (reservoir,
    seeded) of the inputs it is called with; the last ``n_copied``
    arguments (the per-call rows) are cloned, the graph lanes before
    them are kept by reference."""
    rng = random.Random(0)
    seen = [0]

    def wrap(real):
        def recorded(*args):
            k = seen[0]
            seen[0] += 1
            j = k if k < N_SAMPLES else rng.randrange(k + 1)
            if j < N_SAMPLES:           # copy only the inputs kept
                cut = len(args) - n_copied
                item = (*args[:cut], *(a.clone() for a in args[cut:]))
                if j == len(samples):
                    samples.append(item)
                else:
                    samples[j] = item
            return real(*args)
        return recorded
    return wrap


def bound_of(adj, cand, frontier, active) -> tuple[float, float]:
    """Least time (ms) for one dense call on these inputs, as (bytes,
    ops): each input byte read once (of the adjacency, only the rows
    these inputs reference), each output byte written once, over the HBM
    rate; one AND per gathered word over the 32-bit rate."""
    import torch
    f, w = cand.shape
    use = (active != 0) & (frontier >= 0)
    rows = torch.unique(frontier[use].clamp(max=adj.shape[0] - 1)).numel()
    nbytes = 4 * (2 * f * w + frontier.numel() + active.numel() + rows * w)
    ops = int(use.sum()) * w
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S


def hier_bound_of(summary, chunk_ptr, chunk_id, chunk_data, kmax, cand,
                  frontier, active) -> tuple[float, float, dict]:
    """Least time (ms) for one hierarchical call on these inputs, as
    (bytes, ops, counts). Bytes, each read once: cand, frontier, active
    and the output; the summary row and the two ``chunk_ptr`` words of
    each distinct active vertex; of each distinct in-range vertex that an
    active position of a live row (summary intersection not all dead)
    holds, its ``chunk_id`` window; and the C words of each distinct
    stored chunk that such a row finds live. Ops: an OR per cand word for
    its chunk summary, an AND per summary word per active position, an
    AND per output word for the dead-chunk mask, and an AND per word of
    each (row, position, live chunk) triple."""
    import torch
    from repro_torch.kernels.ref import summary_intersect_ref
    v, sw = summary.shape
    c = chunk_data.shape[1]
    f, w = cand.shape
    use = (active != 0) & (frontier >= 0)
    verts = torch.unique(frontier[use].clamp(max=v - 1)).numel()
    sacc = summary_intersect_ref(summary, cand, frontier, active, c)
    live_row = (sacc != 0).any(dim=1)
    walk = use & (frontier < v) & live_row[:, None]
    rows, pos = walk.nonzero(as_tuple=True)
    vtx = frontier[rows, pos].long()
    k0 = chunk_ptr[vtx].long()
    nk = chunk_ptr[vtx + 1].long() - k0
    win = torch.arange(kmax, device=cand.device)
    ks = k0[:, None] + win[None, :]
    stored = win[None, :] < nk[:, None]
    cid = chunk_id[ks].long()
    bit = (sacc[rows][torch.arange(len(rows), device=cand.device)[:, None],
                      cid // 32] >> (cid % 32)) & 1
    live = stored & (bit != 0)
    walked_verts = torch.unique(vtx)
    id_words = int((chunk_ptr[walked_verts + 1]
                    - chunk_ptr[walked_verts]).sum())
    chunks = torch.unique(ks[live]).numel()
    nbytes = 4 * (2 * f * w + frontier.numel() + active.numel()
                  + verts * (sw + 2) + id_words + chunks * c)
    triples = int(live.sum())
    ops = 2 * f * w + int(use.sum()) * sw + triples * c
    counts = {"live_rows": int(live_row.sum()), "walked_positions":
              len(rows), "live_chunk_reads": triples,
              "distinct_live_chunks": chunks, "bytes": nbytes}
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT_OPS_PER_S, counts


def device_ms(fn, samples) -> float:
    """Device time of one call, averaged over ``samples``: the calls are
    captured into one CUDA graph and the replays timed with CUDA events,
    so host launch cost is not in the figure."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in samples:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s in samples:
            fn(*s)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (TIMING_REPS * len(samples))
    del graph
    torch.cuda.empty_cache()
    return ms


def launch_floor_ms(dev) -> float:
    """Device time of the smallest kernel node, by the same CUDA-graph
    replay as the kernels (``zero_()`` of a one-element tensor): the
    fixed cost of a node, beside which a kernel's own work shows."""
    import torch
    one = torch.zeros(1, device=dev)
    return device_ms(torch.Tensor.zero_, [(one,)] * N_SAMPLES)


def eager_ms(fn, samples) -> float:
    """Per-call time as the eager main path sees it (launch included)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        for s in samples:
            fn(*s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (TIMING_REPS * len(samples))


def time_kernel(samples) -> dict:
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows
    from repro_torch.kernels.ref import refine_bitmap_rows_ref
    worst = 0
    for s in samples:
        got, want = refine_bitmap_rows(*s), refine_bitmap_rows_ref(*s)
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        require(torch.equal(got, want),
                "kernel != plain on a captured main-path input")
    bounds = [bound_of(*s) for s in samples]
    t_bytes = sum(b for b, _ in bounds) / len(bounds)
    t_ops = sum(o for _, o in bounds) / len(bounds)
    ms = device_ms(refine_bitmap_rows, samples)
    plain_ms = device_ms(refine_bitmap_rows_ref, samples)
    gathered = [int(((s[3] != 0) & (s[2] >= 0)).sum()) for s in samples]
    return {"ms": ms, "eager_ms": eager_ms(refine_bitmap_rows, samples),
            "plain_ms": plain_ms,
            "plain_eager_ms": eager_ms(refine_bitmap_rows_ref, samples),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "max_abs_err": worst, "samples": len(samples),
            "gathered_rows_per_call": sum(gathered) / len(gathered),
            "shape": list(samples[0][1].shape)}


def hier_against_dense(samples, data) -> dict:
    """The hierarchical kernel against the dense kernel on the dense
    bitmap of the same graph, on captured scale-run inputs (frontier
    values there lie in [-1, V), where the two layouts agree)."""
    import torch
    from repro_torch.kernels.bitmap_refine import (refine_bitmap_rows,
                                                   refine_bitmap_rows_hier)
    adj = torch.from_numpy(data.adj_bitmap.view("int32")).to(
        samples[0][5].device)
    for s in samples:
        hier = refine_bitmap_rows_hier(*s)
        dense = refine_bitmap_rows(adj, *s[5:])
        require(torch.equal(hier, dense), "hier kernel != dense kernel on "
                "a captured scale input")
    out = {"samples": len(samples), "dense_bitmap_bytes": adj.numel() * 4,
           "equal": True}
    del adj
    torch.cuda.empty_cache()
    return out


def time_hier_kernel(samples) -> dict:
    """Hierarchical kernel and plain version on captured scale inputs.
    The plain version is given its position bound (the deepest active
    position, read here beforehand) so that it can be captured into a
    CUDA graph."""
    import torch
    from repro_torch.kernels.bitmap_refine import refine_bitmap_rows_hier
    from repro_torch.kernels.ref import refine_bitmap_rows_hier_ref
    worst = 0
    for s in samples:
        got = refine_bitmap_rows_hier(*s)
        want = refine_bitmap_rows_hier_ref(*s)
        worst = max(worst, int((got.long() - want.long()).abs().max()))
        require(torch.equal(got, want),
                "hier kernel != plain on a captured scale input")
    bounds = [hier_bound_of(*s) for s in samples]
    t_bytes = sum(b[0] for b in bounds) / len(bounds)
    t_ops = sum(b[1] for b in bounds) / len(bounds)
    counts = {k: sum(b[2][k] for b in bounds) / len(bounds)
              for k in bounds[0][2]}

    def positions(s):
        v = s[0].shape[0]
        act = (s[7] != 0) & (s[6] >= 0) & (s[6] < v)
        cols = act.any(dim=0).nonzero()
        return int(cols.max()) + 1 if cols.numel() else 0
    with_pos = [(*s, positions(s)) for s in samples]

    def plain(*s):
        return refine_bitmap_rows_hier_ref(*s[:-1], positions=s[-1])
    timed = samples[:N_TIMED_HIER]
    return {"ms": device_ms(refine_bitmap_rows_hier, timed),
            "eager_ms": eager_ms(refine_bitmap_rows_hier, timed),
            "plain_ms": device_ms(plain, with_pos[:N_TIMED_HIER]),
            "plain_eager_ms": eager_ms(refine_bitmap_rows_hier_ref, timed),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "max_abs_err": worst, "samples_checked": len(samples),
            "samples_timed": len(timed), "per_call": counts,
            "shape": list(samples[0][5].shape),
            "summary_words": int(samples[0][0].shape[1]),
            "chunk_words": int(samples[0][3].shape[1]),
            "kmax": int(samples[0][4])}


def profile_window(dev, wl, name: str, steps: int = 10) -> dict:
    """Where a dispatch of workload ``name`` spends its time:
    ``torch.profiler`` (CPU and CUDA) over ``steps`` scheduler steps of
    its first 8 queries — kernel
    launches and device time (kernels, copies and fills on the card) per
    expansion iteration. The profiler slows the host, so the window's own
    busy share understates the unprofiled one; ``main`` also sets the
    device time per iteration against the main run's wall time per
    iteration. A measurement, not a check: if the profiler cannot trace
    the card here, the figures read "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import QueryServer

    data, queries = wl[name]
    srv = QueryServer(data, backend="engine", device=dev)
    for q in queries[:8]:
        srv.submit_async(q)
    for _ in range(3):                  # admission and the first dispatches
        srv.step()
    sched = srv.scheduler
    it0 = sched.timing["iterations"]
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                srv.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = prof.key_averages()
    except Exception as exc:            # tracing unavailable on this host
        return {"profiled": False, "error": repr(exc)}
    iters = max(1, sched.timing["iterations"] - it0)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    on_card = [e for e in stats
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_card)
    launches = sum(e.count for e in stats
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    top_cpu = sorted(stats, key=lambda e: -e.self_cpu_time_total)[:8]
    top_dev = sorted(on_card, key=lambda e: -dev_us(e))[:5]
    if busy_us <= 0:
        return {"profiled": False, "iterations": iters,
                "kernel_launches_per_iteration": launches / iters}
    return {"profiled": True, "iterations": iters, "wall_s": wall,
            "kernel_launches_per_iteration": launches / iters,
            "device_ms_per_iteration": busy_us / 1e3 / iters,
            "profiled_wall_ms_per_iteration": wall * 1e3 / iters,
            "profiled_busy_share": busy_us / (wall * 1e6),
            "top_self_cpu_us": [[e.key, e.count, e.self_cpu_time_total]
                                for e in top_cpu],
            "top_device_us": [[e.key[:60], e.count, dev_us(e)]
                              for e in top_dev]}


# ----------------------------------------------------------------------
# phases 8-10: the kernel-op layer — SpMM and attention
# ----------------------------------------------------------------------
QWEN3_ATTN = {"h": 16, "h_kv": 8, "d": 128}   # configs/qwen3_0_6b.py
BF16_ATOL_UNITS = 2     # bf16 attention atol, in bf16 units of a row's max
SPMM_TIMED = {"a human f32": "split", "a human bf16": "split",
              "b cora f32": "wide", "b cora bf16": "wide",
              "c scale f32": "stream", "c scale bf16": "stream"}
FLASH_TIMED = {"a prefill bf16": "tc", "a prefill f32": "fma",
               "b decode bf16": "split", "b decode f32": "split"}


def random_words(rng, n: int, w: int, density: float):
    """int32 [n, w] packed rows of a random 0/1 matrix; every third row
    has bit 31 of each word set (negative int32 words)."""
    import numpy as np
    from repro_torch.core.graph import pack_bitmap
    dense = rng.random((n, 32 * w)) < density
    dense[::3, 31::32] = True
    return pack_bitmap(dense).view(np.int32)


def op_cases(dev, wl) -> tuple[dict, dict, list]:
    """The op-layer cases, on ``dev``: SpMM ``{name: (words, x)}``,
    attention ``{name: (q, k, v, causal)}`` and attention calls whose
    blocks do not divide S or Skv (each must raise). Features and
    activations are drawn on the card from a seeded generator."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return (spmm_cases(dev, wl, randn), *flash_cases(randn))


def spmm_cases(dev, wl, randn) -> dict:
    """SpMM ``{name: (words, x)}``: (a)-(c) in f32 and bf16 and the edge
    cases (d), x drawn by ``randn(*shape, dtype=...)``."""
    import numpy as np
    import torch
    from repro_torch.data.graph_gen import er_labeled_graph
    f32, bf16 = torch.float32, torch.bfloat16

    def words_of(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                ).to(dev)
    cora = er_labeled_graph(2708, 5278, 7, seed=0)   # gnn_shapes full_graph_sm
    spmm = {}
    for label, g, d in (("a human", wl["human"][0], 128),
                        ("b cora", cora, 1433),
                        ("c scale", wl["scale"][0], 128)):
        words = words_of(g.adj_bitmap)
        x = randn(32 * words.shape[1], d)
        spmm[f"{label} f32"] = (words, x)
        spmm[f"{label} bf16"] = (words, x.to(bf16))
    human = spmm["a human f32"][0]
    rng = np.random.default_rng(13)
    spmm["d N1"] = (human[:1].contiguous(), randn(human.shape[1] * 32, 128))
    spmm["d M32 bit31"] = (words_of(random_words(rng, 50, 1, 0.3)),
                           randn(32, 8))
    spmm["d D1"] = (human, randn(human.shape[1] * 32, 1))
    spmm["d D129 bf16"] = (human, randn(human.shape[1] * 32, 129, dtype=bf16))
    spmm["d density 0.3 bit31"] = (words_of(random_words(rng, 300, 10, 0.3)),
                                   randn(320, 64))
    # rows of 2101 words (unaligned, five passes of the stream route) with
    # ~2000 set bits (several windows of its list), then the same on wide;
    # x from numpy, so that the generator's later draws stay as they were
    long_rows = words_of(random_words(rng, 40, 2101, 0.03))
    for d in (64, 300):
        spmm[f"d W2101 D{d}"] = (long_rows, torch.from_numpy(
            rng.standard_normal((32 * 2101, d)).astype(np.float32)).to(dev))
    return spmm


def flash_cases(randn) -> tuple[dict, list]:
    """Attention ``{name: (q, k, v, causal)}`` and the calls whose blocks
    do not divide S or Skv."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    h, h_kv, d = QWEN3_ATTN["h"], QWEN3_ATTN["h_kv"], QWEN3_ATTN["d"]

    def qkv(b, hq, hk, s, skv, dd, dtype):
        return (randn(b, hq, s, dd, dtype=dtype),
                randn(b, hk, skv, dd, dtype=dtype),
                randn(b, hk, skv, dd, dtype=dtype))
    flash = {}
    prefill = qkv(1, h, h_kv, 4096, 4096, d, f32)       # lm_shapes train_4k
    flash["a prefill bf16"] = (*(t.to(bf16) for t in prefill), True)
    flash["a prefill f32"] = (*prefill, True)
    decode = qkv(4, h, h_kv, 1, 32768, d, f32)          # lm_shapes decode_32k
    flash["b decode bf16"] = (*(t.to(bf16) for t in decode), False)
    flash["b decode f32"] = (*decode, False)
    flash["c D16 group1"] = (*qkv(1, 4, 4, 256, 256, 16, f32), True)
    flash["c D64 group8 bf16"] = (*qkv(2, 16, 2, 128, 128, 64, bf16), True)
    flash["c D256"] = (*qkv(1, 4, 2, 128, 128, 256, f32), True)
    flash["c causal S<Skv"] = (*qkv(1, h, h_kv, 256, 1024, d, f32), True)
    flash["c causal S<Skv bf16"] = (*qkv(1, h, h_kv, 64, 4096, d, bf16),
                                    True)
    flash["c decode B1 bf16"] = (*qkv(1, h, h_kv, 1, 32768, d, bf16), False)
    flash["c S8 group8"] = (*qkv(1, 8, 1, 8, 4096, d, f32), True)
    flash["c S8 group8 bf16"] = (*qkv(2, 8, 1, 8, 4096, d, bf16), False)
    flash["c D64 prefill bf16"] = (*qkv(1, 8, 4, 1024, 1024, 64, bf16),
                                   True)
    flash["c D256 prefill bf16"] = (*qkv(1, 4, 2, 512, 768, 256, bf16),
                                    True)
    odd = qkv(1, 2, 2, 96, 96, 64, f32)
    bad_blocks = [(odd, {"block_q": 64}), (odd, {"block_k": 64})]
    return flash, bad_blocks


def drive_ops(spmm, flash, bad_blocks, refine_args, hier_args) -> dict:
    """The op layer's main run: every case once through
    ``repro_torch.kernels.ops``, each kernel's launch count set to 0 just
    before and read just after. Returns the outputs and the counts."""
    import torch
    from repro_torch.kernels import (bitmap_refine, bitmap_spmm,
                                     flash_attention, ops)
    bitmap_refine.LAUNCHES = bitmap_refine.HIER_LAUNCHES = 0
    bitmap_spmm.SPMM_LAUNCHES = flash_attention.FLASH_LAUNCHES = 0
    bitmap_spmm.SPMM_ROUTES.update(split=0, stream=0, wide=0)
    flash_attention.FLASH_ROUTES.update(split=0, tc=0, fma=0)
    out = {"spmm": {k: ops.bitmap_spmm_op(*a) for k, a in spmm.items()},
           "flash": {k: ops.flash_attention_op(q, k_, v, causal=c)
                     for k, (q, k_, v, c) in flash.items()}}
    adj, cand, fr, act = refine_args
    out["refine"] = ops.refine_bitmap_rows_op(adj, cand, fr, act)
    out["refine_single"] = ops.refine_bitmap_op(adj, cand[0], fr, act[0])
    out["refine_hier"] = ops.refine_bitmap_rows_hier_op(*hier_args)
    raised = 0
    for (q, k, v), blocks in bad_blocks:
        try:
            ops.flash_attention_op(q, k, v, **blocks)
        except ValueError:
            raised += 1
    torch.cuda.synchronize()
    out["launches"] = {"bitmap_spmm": bitmap_spmm.SPMM_LAUNCHES,
                       "flash_attention": flash_attention.FLASH_LAUNCHES,
                       "refine_bitmap_rows": bitmap_refine.LAUNCHES,
                       "refine_bitmap_rows_hier": bitmap_refine.HIER_LAUNCHES}
    out["flash_routes"] = dict(flash_attention.FLASH_ROUTES)
    out["spmm_routes"] = dict(bitmap_spmm.SPMM_ROUTES)
    require(raised == len(bad_blocks), "flash_attention_op took blocks that "
            "do not divide S or Skv")
    require(out["launches"] == {
        "bitmap_spmm": len(spmm), "flash_attention": len(flash),
        "refine_bitmap_rows": 2, "refine_bitmap_rows_hier": 1},
        f"op-layer launches {out['launches']}: not one per op call")
    require(all(n > 0 for n in out["spmm_routes"].values())
            and sum(out["spmm_routes"].values()) == len(spmm),
            f"SpMM routes {out['spmm_routes']}: each route must launch, "
            "once per op call in all")
    require(all(out["flash_routes"][r] > 0 for r in ("split", "tc", "fma"))
            and sum(out["flash_routes"].values()) == len(flash),
            f"attention routes {out['flash_routes']}: each route must "
            "launch, once per op call in all")
    return out


def close_err(got, want, tol: float, atol, tag: str = "") -> float:
    """Max abs error of ``got`` against ``want`` (compared in f32);
    fails unless ``|got - want| <= atol + tol * |want|`` everywhere
    (``atol`` a number or a tensor that broadcasts against ``want``);
    ``tag`` names the output in the failure."""
    import torch
    g, w = got.float(), want.float()
    require(g.shape == w.shape and got.dtype == want.dtype,
            f"{tag} shape/dtype {tuple(got.shape)} {got.dtype} != "
            f"{tuple(want.shape)} {want.dtype}")
    require(bool(torch.isfinite(g).all()), f"{tag} non-finite output")
    diff = (g - w).abs()
    require(bool((diff <= atol + tol * w.abs()).all()),
            f"{tag} max abs err {float(diff.max())} past rtol {tol} atol "
            f"{float(torch.as_tensor(atol).max())}")
    return float(diff.max()) if diff.numel() else 0.0


def check_ops(run, spmm, flash, refine_args, hier_args) -> dict:
    """Each op output against its plain version on the card: SpMM within
    rtol / atol 1e-5 (f32) and 2e-2 (bf16), the reference's tolerances;
    attention within rtol / atol 2e-4 (f32) and, in bf16, rtol 2e-2 with
    an atol of ``BF16_ATOL_UNITS`` bf16 units (2**-8) of each output
    row's largest ``|want|`` — the reference's flat 2e-2 is larger than
    the outputs of a long softmax (spread ~0.01 at 32768 keys), and both
    sides sum in f32 from the same bf16 inputs, so they differ by a
    rounding flip of the bf16 output (within rtol) and f32 noise; refines
    bit for bit."""
    import torch
    from repro_torch.kernels.ref import (bitmap_spmm_ref,
                                         flash_attention_ref,
                                         refine_bitmap_rows_hier_ref,
                                         refine_bitmap_rows_ref)
    worst = {"bitmap_spmm": 0.0, "flash_attention": 0.0}
    for name, (words, x) in spmm.items():
        tol = 1e-5 if x.dtype == torch.float32 else 2e-2
        err = close_err(run["spmm"][name], bitmap_spmm_ref(words, x), tol,
                        max(tol, 1e-5))
        worst["bitmap_spmm"] = max(worst["bitmap_spmm"], err)
        info("spmm-check", case=name, n=words.shape[0], w=words.shape[1],
             d=x.shape[1], dtype=str(x.dtype), max_abs_err=err)
    for name, (q, k, v, causal) in flash.items():
        want = flash_attention_ref(q, k, v, causal=causal)
        if q.dtype == torch.float32:
            tol, atol = 2e-4, 2e-4
        else:
            tol = 2e-2
            atol = (BF16_ATOL_UNITS * 2.0 ** -8
                    * want.float().abs().amax(-1, keepdim=True))
        err = close_err(run["flash"][name], want, tol, atol)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        info("flash-check", case=name, q=list(q.shape), kv=list(k.shape),
             causal=causal, dtype=str(q.dtype), max_abs_err=err, rtol=tol,
             max_atol=float(torch.as_tensor(atol).max()))
        torch.cuda.empty_cache()
    adj, cand, fr, act = refine_args
    want = refine_bitmap_rows_ref(adj, cand, fr, act)
    require(torch.equal(run["refine"], want), "refine_bitmap_rows_op != plain")
    single = refine_bitmap_rows_ref(adj, cand[:1].expand_as(cand).contiguous(),
                                    fr, act[:1].expand_as(act).contiguous())
    require(torch.equal(run["refine_single"], single),
            "refine_bitmap_op != plain")
    require(torch.equal(run["refine_hier"],
                        refine_bitmap_rows_hier_ref(*hier_args)),
            "refine_bitmap_rows_hier_op != plain")
    return worst


def spmm_csr(words, dtype):
    """The CSR of the 0/1 matrix packed in ``words`` (values 1 in
    ``dtype``), unpacked a row block at a time — the library yardstick's
    operand, built outside its timing."""
    import torch
    from repro_torch.kernels.ref import SPMM_ROW_BLOCK, unpack_rows
    n, w = words.shape
    rows, cols = [], []
    for i in range(0, n, SPMM_ROW_BLOCK):
        r, c = unpack_rows(words, i, min(i + SPMM_ROW_BLOCK, n)
                           ).nonzero(as_tuple=True)
        rows.append(r + i)
        cols.append(c)
    rows, cols = torch.cat(rows), torch.cat(cols)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=words.device)
    crow[1:] = torch.bincount(rows, minlength=n).cumsum(0)
    vals = torch.ones(cols.numel(), dtype=dtype, device=words.device)
    return torch.sparse_csr_tensor(crow, cols, vals, size=(n, 32 * w))


def spmm_bound(words, x, csr) -> tuple[float, float, dict]:
    """Least time (ms) for one SpMM on these inputs, as (bytes, ops):
    the words once, the x rows of the distinct set columns once, the
    output once, over the HBM rate; one f32 add per set bit and column
    over the f32 rate."""
    n, w = words.shape
    es = x.element_size()
    nnz = int(csr.values().numel())
    cols = int(csr.col_indices().unique().numel())
    nbytes = 4 * n * w + es * x.shape[1] * (cols + n)
    ops_ = nnz * x.shape[1]
    return (1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops_ / F32_OPS_PER_S,
            {"nnz": nnz, "distinct_columns": cols, "bytes": nbytes})


def flash_bound(q, k, causal: bool) -> tuple[float, float, dict]:
    """Least time (ms) for one attention call, as (bytes, ops): q, k, v
    and the output once each, over the HBM rate; 4 D flops per visible
    (query, key) pair over the peak of the input type (bf16 tensor
    cores, exact f32 outside them)."""
    b, h, s, d = q.shape
    s_kv = k.shape[2]
    es = q.element_size()
    nbytes = es * (2 * q.numel() + 2 * k.numel())
    if causal:      # query i sees min(i + 1, Skv) keys
        m = min(s, s_kv)
        pairs = m * (m + 1) // 2 + (s - m) * s_kv
    else:
        pairs = s * s_kv
    flops = 4 * d * b * h * pairs
    peak = BF16_OPS_PER_S if q.element_size() == 2 else F32_OPS_PER_S
    return (1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak,
            {"visible_pairs": b * h * pairs, "flops": flops,
             "bytes": nbytes})


def library_ms(fn, args) -> float:
    """The yardstick's time: back-to-back eager calls timed with CUDA
    events after a warm-up (a library call may allocate, so it is not
    captured into a CUDA graph)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    return eager_ms(fn, [args])


def timing_row(ms, plain_ms, lib, t_bytes, t_ops, **extra):
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, **extra}


def time_ops(spmm, flash) -> dict:
    """Device time per call (CUDA-graph replay) of each kernel and its
    plain version on the timed cases, beside the bound and the library
    call that computes the same function (``torch.sparse.mm`` on the CSR
    of the same matrix, TF32 off; ``scaled_dot_product_attention`` with
    ``enable_gqa``, whose ``is_causal`` is top-left aligned too)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.bitmap_spmm import SPMM_ROUTES, bitmap_spmm
    from repro_torch.kernels.flash_attention import (FLASH_ROUTES,
                                                     flash_attention)
    from repro_torch.kernels.ref import bitmap_spmm_ref, flash_attention_ref
    out = {}
    for name, route in SPMM_TIMED.items():
        words, x = spmm[name]
        csr = spmm_csr(words, x.dtype)
        t_bytes, t_ops, counts = spmm_bound(words, x, csr)
        before = dict(SPMM_ROUTES)
        ms = device_ms(bitmap_spmm, [(words, x)])
        taken = {r: n - before[r] for r, n in SPMM_ROUTES.items()
                 if n != before[r]}
        require(list(taken) == [route], f"SpMM {name} took routes {taken}, "
                f"expected {route!r}")
        out[name] = timing_row(
            ms, device_ms(bitmap_spmm_ref, [(words, x)]),
            library_ms(torch.sparse.mm, (csr, x)), t_bytes, t_ops,
            eager_ms=eager_ms(bitmap_spmm, [(words, x)]), route=route,
            gathered_bytes=counts["nnz"] * x.shape[1] * x.element_size(),
            **counts)
        info("spmm-time", case=name, **out[name])
        del csr
        torch.cuda.empty_cache()
    for name, route in FLASH_TIMED.items():
        q, k, v, causal = flash[name]
        t_bytes, t_ops, counts = flash_bound(q, k, causal)

        def kernel(q, k, v, causal=causal):
            return flash_attention(q, k, v, causal=causal)

        def plain(q, k, v, causal=causal):
            return flash_attention_ref(q, k, v, causal=causal)

        def sdpa(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        before = dict(FLASH_ROUTES)
        ms = device_ms(kernel, [(q, k, v)])
        taken = {r: n - before[r] for r, n in FLASH_ROUTES.items()
                 if n != before[r]}
        require(list(taken) == [route], f"attention {name} took routes "
                f"{taken}, expected {route!r}")
        out[name] = timing_row(
            ms, device_ms(plain, [(q, k, v)]), library_ms(sdpa, (q, k, v)),
            t_bytes, t_ops, eager_ms=eager_ms(kernel, [(q, k, v)]),
            route=route, **counts)
        info("flash-time", case=name, **out[name])
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phases 11/12: the fault-tolerant runtime and the distributed matcher
# ----------------------------------------------------------------------
N_FAULT_QUERIES = 4          # phase 11 serves the first 4 human queries


def fault_specs() -> list:
    """Phase 11's plan: a retried dispatch exception, one that exhausts
    the retries, a hang, a corrupt and an overflowing digest aimed at one
    slot each, a dropped flush and a failed admission (the last query's)."""
    from repro_torch.api import MatchOptions
    from repro_torch.core.faults import FaultSpec
    retries = MatchOptions().dispatch_retries
    return [FaultSpec("dispatch", "exception", at=2),
            FaultSpec("dispatch", "exception", at=6, times=retries + 1),
            FaultSpec("dispatch", "hang", at=12),
            FaultSpec("digest", "corrupt", at=1, slot=0),
            FaultSpec("digest", "overflow", at=3, slot=1),
            FaultSpec("flush", "exception", at=1),
            FaultSpec("admission", "exception", at=N_FAULT_QUERIES)]


def serve_faulted(dev, data, queries, specs, **knobs) -> tuple:
    """One QueryServer on the card under ``FaultPlan(specs)``; returns
    the results, the plan, the fault counters and the refine launches
    (set to 0 just before)."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.serving import QueryServer
    plan = FaultPlan(specs)
    srv = QueryServer(data, backend="engine", device=dev, faults=plan,
                      **knobs)
    reset_refine_launches()
    res = srv.submit_batch(queries)
    return (res, plan, srv.scheduler.scheduler_stats()["faults"],
            refine_launches())


def fired(plan) -> list:
    return [[site, kind, n] for site, kind, n, _ in plan.fired]


def fault_phase(dev, wl, base: list, want_n: list) -> dict:
    """Phase 11: the first four human queries under one plan holding
    every dispatch, digest, flush and admission fault (see
    ``fault_specs``), then a slot-aimed corrupt digest alone beside a
    fault-free run of the same batch. ``base`` are phase 3's results of
    these queries, ``want_n`` their oracle counts (limit 1000)."""
    import torch
    from repro_torch.core.faults import FaultSpec
    data, queries = wl["human"]
    queries = queries[:N_FAULT_QUERIES]
    t0 = time.perf_counter()
    specs = fault_specs()
    res, plan, counters, launches = serve_faulted(dev, data, queries,
                                                  specs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = {(site, kind, n) for site, kind, n, _ in plan.fired}
    for spec in specs:
        for n in range(spec.at, spec.at + spec.times):
            require((spec.site, spec.kind, n) in got,
                    f"faults: {spec} did not fire at crossing {n}")
    require(res[-1].status == "error",
            f"faults: the failed admission ended {res[-1].status}")
    for i, r in enumerate(res[:-1]):
        require(r.status in ("ok", "limit"), f"faults q{i}: {r.status}")
        check_rows(f"faults q{i}", queries[i], data, r.embeddings,
                   want_n[i], emb_set(base[i].embeddings)
                   if base[i].status == "ok" else None)
    demoted = sum(bool(r.stats.fallback) for r in res)
    require(1 <= demoted <= counters["fallbacks"],
            f"faults: {demoted} results on the degraded path, "
            f"{counters['fallbacks']} demotions")
    for k in ("hangs", "quarantined", "fallbacks", "flush_drops",
              "admission_failures"):
        require(counters[k] >= 1, f"faults: counter {k} is 0")
    require(launches["dense"] > 0, "faults: the dense refine never "
            "launched")
    out = {"seconds": seconds, "launches": launches, "faults": counters,
           "fired": fired(plan), "statuses": [r.status for r in res],
           "fallback": [bool(r.stats.fallback) for r in res]}
    info("faults", **out)

    # a corrupt digest aimed at slot 0 alone: every other query of the
    # batch must come out as in a fault-free run, rows and counters. The
    # adaptive-depth prune EMA is one per scheduler, so the quarantined
    # slot's zeroed lanes and its replay would move every slot's depth
    # choice (and with it the counters of queries cut at the limit):
    # both runs pin the deep schedule to keep the slots apart
    t0 = time.perf_counter()
    pinned = {"adaptive_prune_threshold": 1.0}
    clean, _, clean_counters, _ = serve_faulted(dev, data, queries, [],
                                                **pinned)
    hit, plan, counters, launches = serve_faulted(
        dev, data, queries, [FaultSpec("digest", "corrupt", at=1, slot=0)],
        **pinned)
    torch.cuda.synchronize()
    require(not any(clean_counters.values()),
            f"faults: fault counters {clean_counters} without a plan")
    require(counters["digest_failures"] == 1
            and counters["quarantined"] == 1,
            f"faults: slot-aimed corrupt digest gave {counters}")
    keys = ("deadend_prunes", "rows_created", "patterns_stored",
            "injectivity_fails")
    untouched = [i for i, r in enumerate(hit) if not r.stats.fallback]
    require(len(untouched) == len(queries) - 1,
            "faults: the corrupt digest demoted more than its slot")
    for i, r in enumerate(hit):
        require(r.status == clean[i].status, f"faults q{i}: {r.status} "
                f"against {clean[i].status} without faults")
        check_rows(f"faults q{i} (slot-aimed)", queries[i], data,
                   r.embeddings, want_n[i])
    for i in untouched:
        require(sorted(emb_set(hit[i].embeddings))
                == sorted(emb_set(clean[i].embeddings)),
                f"faults q{i}: a neighbour's rows changed")
        for k in keys:
            require(getattr(hit[i].stats, k) == getattr(clean[i].stats, k),
                    f"faults q{i}: a neighbour's {k} changed")
    blast = {"seconds": time.perf_counter() - t0, "launches": launches,
             "faults": counters, "fired": fired(plan),
             "untouched": untouched,
             "rows_created": {"fault_free": [r.stats.rows_created
                                             for r in clean],
                              "faulted": [r.stats.rows_created
                                          for r in hit]}}
    info("faults-slot", **blast)
    return {**out, "slot_aimed": blast}


def distributed_phase(dev, wl, base_human: list, base_scale: list) -> dict:
    """Phase 12: ``DistributedMatcher`` on the card. (a) two human
    queries that phase 3 finished under the limit, 4 shards, with a
    checkpoint directory; (b) the larger of them losing a shard at its
    second wave, micro-checkpointed every wave; (c) the same query cut
    by ``max_rows`` and resumed from its checkpoint on 2 shards; (d) one
    scale query (hier layout and kernel). Each part's refine launches are
    set to 0 just before it."""
    import torch
    from repro_torch.core.distributed import DistributedMatcher
    from repro_torch.core.faults import FaultPlan, FaultSpec
    human, hq = wl["human"]
    scale, sq = wl["scale"]
    done = sorted((i for i, r in enumerate(base_human)
                   if r.status == "ok" and r.embeddings),
                  key=lambda i: base_human[i].stats.rows_created)[:2]
    require(len(done) == 2, "distributed: phase 3 finished fewer than two "
            "human queries under the limit")
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sets, rows = {}, {}
        t0 = time.perf_counter()
        reset_refine_launches()
        for i in done:
            m = DistributedMatcher(human, n_shards=4, device=dev)
            r = m.match(hq[i], limit=1000, checkpoint_dir=str(tmp / f"a{i}"))
            want = emb_set(base_human[i].embeddings)
            check_rows(f"distributed (a) q{i}", hq[i], human, r.embeddings,
                       len(want), want)
            require(DistributedMatcher.load_state(str(tmp / f"a{i}"))
                    is not None, f"distributed (a) q{i}: no checkpoint")
            sets[i], rows[i] = want, r.stats.rows_created
        torch.cuda.synchronize()
        out["a"] = {"queries": done, "rows": [rows[i] for i in done],
                    "found": [len(sets[i]) for i in done],
                    "seconds": time.perf_counter() - t0,
                    "launches": refine_launches()}
        info("distributed-a", **out["a"])
        j = done[-1]

        t0 = time.perf_counter()
        reset_refine_launches()
        plan = FaultPlan([FaultSpec("shard", "shard_loss", at=2)])
        m = DistributedMatcher(human, n_shards=4, micro_checkpoint_every=1,
                               faults=plan, device=dev)
        r = m.match(hq[j], limit=1000, checkpoint_dir=str(tmp / "b"))
        torch.cuda.synchronize()
        require(m.n_shards == 3, f"distributed (b): {m.n_shards} shards "
                "after a shard loss")
        check_rows(f"distributed (b) q{j}", hq[j], human, r.embeddings,
                   len(sets[j]), sets[j])
        out["b"] = {"query": j, "n_shards": m.n_shards,
                    "fired": fired(plan),
                    "faults": m.scheduler.scheduler_stats()["faults"],
                    "seconds": time.perf_counter() - t0,
                    "launches": refine_launches()}
        info("distributed-b", **out["b"])

        t0 = time.perf_counter()
        reset_refine_launches()
        cut = max(1, rows[j] // 2)
        m = DistributedMatcher(human, n_shards=4, checkpoint_every_waves=2,
                               device=dev)
        part = m.match(hq[j], limit=1000, checkpoint_dir=str(tmp / "c"),
                       max_rows=cut)
        require(part.stats.aborted and part.stats.abort_reason == "rows",
                "distributed (c): the run was not cut by max_rows")
        ck = DistributedMatcher.load_state(str(tmp / "c"))
        require(ck is not None and len(ck.pending_roots) > 0,
                "distributed (c): no mid-run checkpoint")
        m2 = DistributedMatcher(human, n_shards=2, device=dev)
        r = m2.match(hq[j], limit=1000, checkpoint_dir=str(tmp / "c"),
                     resume=True)
        torch.cuda.synchronize()
        check_rows(f"distributed (c) q{j}", hq[j], human, r.embeddings,
                   len(sets[j]), sets[j])
        out["c"] = {"query": j, "max_rows": cut,
                    "cut_found": len(part.embeddings),
                    "pending_roots": len(ck.pending_roots),
                    "phi_floor": ck.phi_floor,
                    "seconds": time.perf_counter() - t0,
                    "launches": refine_launches()}
        info("distributed-c", **out["c"])

    k = min((i for i, r in enumerate(base_scale) if r.embeddings),
            key=lambda i: base_scale[i].stats.rows_created)
    t0 = time.perf_counter()
    reset_refine_launches()
    m = DistributedMatcher(scale, n_shards=4, device=dev)
    r = m.match(sq[k], limit=1000)
    torch.cuda.synchronize()
    launches = refine_launches()
    variant = m.scheduler.adjacency_variant
    require(variant == "hier-hbm", f"distributed (d): layout {variant}")
    require(launches["hier"] > 0 and launches["dense"] == 0,
            f"distributed (d): refine launches {launches}")
    base = base_scale[k]
    check_rows(f"distributed (d) q{k}", sq[k], scale, r.embeddings,
               len(base.embeddings), emb_set(base.embeddings)
               if base.status == "ok" else None)
    out["d"] = {"query": k, "variant": variant, "found": len(r.embeddings),
                "rows": r.stats.rows_created,
                "seconds": time.perf_counter() - t0, "launches": launches}
    info("distributed-d", **out["d"])
    info("distributed", seconds=sum(v["seconds"] for v in out.values()),
         launches={k: sum(v["launches"][k] for v in out.values())
                   for k in ("dense", "hier")},
         faults=out["b"]["faults"], fired=out["b"]["fired"])
    return out


# ----------------------------------------------------------------------
# phases 13/14: the tuner and the network server
# ----------------------------------------------------------------------
THRESHOLD_SHAPES = (4674, 65536, 262144)   # human-like, scale, phase 2
N_SERVED = 8                 # phase 14 streams the 8 cheapest scale queries
# The server's default per-query limit, which its warmup ladder (39
# four-vertex queries) runs at: at limit 1000 the ladder takes ~4300
# megastep iterations on the scale graph (minutes), at 10 about 150. The
# streamed queries ask for phase 3's limit (1000) in their options.
WARMUP_LIMIT = 10
SERVER_TENANTS = {"alpha": {"weight": 2}, "beta": {"weight": 1}}


def tuner_phase(dev) -> dict:
    """Phase 13: the autotuner at the smoke shape on ``dev`` into a
    temporary cache file (one digest across its points, or it refuses
    to write), a knob-free scheduler resolving that record, and the
    space's dense / hier verdicts at the serving shapes."""
    import os
    import torch
    from repro_torch.api import MatchOptions
    from repro_torch.api.options import ENGINE_TUNABLE_DEFAULTS
    from repro_torch.core.vectorized import WaveScheduler
    from repro_torch.kernels.config import device_backend
    from repro_torch.tuning import device_kind
    from repro_torch.tuning.autotune import autotune
    from repro_torch.tuning.measure import (SMOKE_SHAPE, _embeddings_digest,
                                            smoke_workload)
    from repro_torch.tuning.space import (CandidateConfig, TunableSpace,
                                          WorkloadShape,
                                          dense_adjacency_bytes,
                                          hier_refine_smem_bytes)
    backend = device_backend(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "TUNING_CACHE_TORCH.json")
        reset_refine_launches()
        try:
            rep = autotune(smoke=True, trials=2, cache_path=path,
                           device=dev)
        except RuntimeError as exc:
            raise SmokeFailure(f"tuner: {exc}") from exc
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = refine_launches()
        prev = os.environ.get("REPRO_TORCH_TUNING_CACHE")
        os.environ["REPRO_TORCH_TUNING_CACHE"] = path
        try:
            s = SMOKE_SHAPE
            data, queries = smoke_workload()
            sched = WaveScheduler(data, options=MatchOptions(
                limit=s["limit"], time_budget_s=s["time_budget_s"],
                kpr=s["kpr"]), device=dev)
            for q in queries:
                sched.submit(q)
            digest = _embeddings_digest(sched.run())
            tuning = sched.scheduler_stats()["tuning"]
        finally:
            if prev is None:
                os.environ.pop("REPRO_TORCH_TUNING_CACHE")
            else:
                os.environ["REPRO_TORCH_TUNING_CACHE"] = prev
    want_key = f"{backend}/{device_kind(dev)}/v{s['n_vertices']}"
    require(rep["backend"] == backend,
            f"tuner: tuned backend {rep['backend']}, the device's {backend}")
    require(rep.get("record") == want_key,
            f"tuner: wrote {rep.get('record')}, expected {want_key}")
    require(launches["dense"] > 0 and launches["hier"] == 0,
            f"tuner: refine launches {launches}")
    require(tuning["source"] == "tuning-cache"
            and tuning["key"] == want_key and tuning["record"] == want_key,
            f"tuner: the knob-free scheduler resolved {tuning}")
    best = rep["best"]["params"]
    require(all(tuning["params"][k] == best[k]
                for k in ENGINE_TUNABLE_DEFAULTS),
            f"tuner: resolved {tuning['params']} against the record {best}")
    require(digest == rep["digest"],
            "tuner: the knob-free scheduler's embeddings differ from the "
            "tuner's")
    verdicts = {}
    for v in THRESHOLD_SHAPES:
        shape = WorkloadShape.for_graph(v)
        space = TunableSpace(backend, shape)
        verdicts[v] = {
            "dense_bytes": dense_adjacency_bytes(shape),
            "dense": space.validate(CandidateConfig()) or "admissible",
            "hier_smem_bytes": hier_refine_smem_bytes(shape, 8),
            "hier": (space.validate(CandidateConfig(hbm_adjacency=1))
                     or "admissible")}
    out = {"seconds": time.perf_counter() - t0, "record": want_key,
           "digest": rep["digest"], "launches": launches,
           "points": [{"megastep_depth": m["params"]["megastep_depth"],
                       "pattern_capacity": m["params"]["pattern_capacity"],
                       "qps": m["qps"],
                       "store_load_factor": m["store_load_factor"]}
                      for m in rep["measured"]],
           "best": rep["best"], "default_qps": rep["default_qps"],
           "refine_microbench_ms": rep["refine_microbench_ms"],
           "rejected": rep["n_rejected"],
           "smem_limit_bytes": space.smem_limit_bytes,
           "dense_budget_bytes": space.dense_budget_bytes,
           "verdicts": verdicts}
    info("tuner", **out)
    return out


def wait_ready(proc, err_path: str, timeout_s: float) -> dict:
    """The server's READY line, or a failure naming what it printed."""
    import select
    deadline = time.monotonic() + timeout_s
    while True:
        left = deadline - time.monotonic()
        if proc.poll() is not None or left <= 0:
            proc.kill()
            proc.wait()
            tail = Path(err_path).read_text()[-2000:]
            raise SmokeFailure(f"server: no READY line (exit code "
                               f"{proc.returncode}): {tail}")
        if select.select([proc.stdout], [], [], min(left, 1.0))[0]:
            line = proc.stdout.readline()
            if line.startswith("REPRO_SERVER_READY "):
                return json.loads(line.split(" ", 1)[1])


def stream_one(cli, query, tenant: str, i: int) -> dict:
    """One streamed query: its rows, statuses and client-side times."""
    t0 = time.perf_counter()
    rows, first, chunks, res = [], None, 0, None
    for ev in cli.stream(query, tenant=tenant, request_id=i,
                         options={"limit": 1000}):
        if ev["event"] == "chunk":
            if first is None and ev["rows"]:
                first = time.perf_counter() - t0
            rows.extend(ev["rows"])
            chunks += 1
        elif ev["event"] == "done":
            res = ev["result"]
        elif ev["event"] == "error":
            raise SmokeFailure(f"server q{i}: {ev['code']}: "
                               f"{ev['message']}")
    return {"rows": rows, "chunks": chunks, "result": res,
            "ttfe_s": first, "latency_s": time.perf_counter() - t0}


def server_phase(dev, wl, base_scale: list) -> dict:
    """Phase 14: ``python -m repro_torch.server.launch`` on ``dev`` over
    the scale graph with two tenants; the 8 scale queries phase 3 ran
    with the fewest rows, streamed concurrently over ``ServeClient``;
    ``/slo`` and ``/metrics``; the hier launches of the streamed queries
    (the difference of two ``/metrics`` snapshots); a SIGTERM drain."""
    import os
    import signal
    import threading
    import numpy as np
    from repro_torch.kernels.config import device_backend
    from repro_torch.server.client import ServeClient
    scale, sq = wl["scale"]
    picks = sorted(range(len(base_scale)),
                   key=lambda i: base_scale[i].stats.rows_created)[:N_SERVED]
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "repro_torch.server.launch",
           "--device", dev.type, "--graph", "powerlaw",
           "--graph-n", str(scale.n), "--graph-m", "3",
           "--graph-labels", "16", "--graph-seed", "0", "--port", "0",
           "--time-budget-s", "600", "--limit", str(WARMUP_LIMIT),
           "--quiet",
           "--tenants", json.dumps(SERVER_TENANTS)]
    with tempfile.TemporaryDirectory() as tmp:
        err_path = str(Path(tmp) / "server.err")
        with open(err_path, "w") as err:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=err)
        try:
            ready = wait_ready(proc, err_path, 300)
            t_ready = time.perf_counter() - t0
            require(ready["n_vertices"] == scale.n,
                    f"server: serves {ready['n_vertices']} vertices")
            cli = ServeClient(ready["host"], ready["port"], timeout=600)
            before = cli.metrics()["kernel_launches"]
            out: list = [None] * len(picks)
            errors: list = []

            def drive(j, i):
                try:
                    out[j] = stream_one(cli, sq[i], "alpha" if j % 2 == 0
                                        else "beta", i)
                except Exception as exc:        # reported below
                    errors.append(f"q{i}: {exc!r}")

            t_wire = time.perf_counter()
            threads = [threading.Thread(target=drive, args=(j, i))
                       for j, i in enumerate(picks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wire_s = time.perf_counter() - t_wire
            require(not errors and all(not t.is_alive() for t in threads),
                    f"server: streams failed: {errors}")
            after = cli.metrics()
            # /slo serves the engine thread's snapshot, refreshed every
            # 0.25 s: wait until it holds the streamed queries
            deadline = time.monotonic() + 30
            while (slo := cli.slo()).get("n", 0) < len(picks) \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        err_text = Path(err_path).read_text()
    require(rc == 0, f"server: SIGTERM drain exited {rc}: {err_text[-2000:]}")
    require("REPRO_SERVER_SLO " in err_text,
            "server: no final SLO report after the drain")
    launches = {k: after["kernel_launches"][k] - before[k] for k in before}
    require(launches["refine_bitmap_rows_hier"] > 0
            and launches["refine_bitmap_rows"] == 0,
            f"server: refine launches {launches}")
    for j, i in enumerate(picks):
        r, base = out[j], base_scale[i]
        res = r["result"]
        require(res is not None and res["status"] in ("ok", "limit"),
                f"server q{i}: {res and res['status']}")
        require(res["status"] == base.status,
                f"server q{i}: {res['status']}, phase 3 {base.status}")
        check_rows(f"server q{i}", sq[i], scale, r["rows"],
                   len(base.embeddings), emb_set(base.embeddings)
                   if base.status == "ok" else None)
        if r["rows"]:
            require(res["ttfe_ms"] is not None
                    and res["ttfe_ms"] < res["latency_ms"],
                    f"server q{i}: TTFE {res['ttfe_ms']} ms, latency "
                    f"{res['latency_ms']} ms")
    require(slo.get("n", 0) >= len(picks) and "p50_ms" in slo,
            f"server: /slo holds {slo.get('n')} queries: {sorted(slo)}")
    require(after["wire"]["completed"] >= len(picks),
            f"server: /metrics wire {after['wire']}")
    tuning = after["engine"]["tuning"]
    require(tuning["source"] == "builtin"
            and tuning["backend"] == device_backend(dev),
            f"server: engine knobs resolved {tuning}, expected the "
            f"built-ins of backend {device_backend(dev)}")
    lat = np.array([r["latency_s"] for r in out]) * 1e3
    ttfe = np.array([r["ttfe_s"] for r in out if r["ttfe_s"] is not None]
                    ) * 1e3
    res = {"seconds": time.perf_counter() - t0, "ready_s": t_ready,
           "warmup_s": ready["warmup_s"],
           "baseline_qps": ready["baseline_qps"], "queries": picks,
           "wire_s": wire_s, "wire_qps": len(picks) / wire_s,
           "client_p50_ms": float(np.percentile(lat, 50)),
           "client_p99_ms": float(np.percentile(lat, 99)),
           "client_ttfe_p50_ms": (float(np.percentile(ttfe, 50))
                                  if len(ttfe) else None),
           "server_p50_ms": slo["p50_ms"], "server_p99_ms": slo["p99_ms"],
           "server_ttfe_p50_ms": slo.get("ttfe_p50_ms"),
           "rows": sum(len(r["rows"]) for r in out),
           "chunks": sum(r["chunks"] for r in out),
           "statuses": [r["result"]["status"] for r in out],
           "launches": launches, "tuning": tuning["source"],
           "drain_rc": rc}
    info("server", **res)
    return res


# ----------------------------------------------------------------------
# phase 15: the model zoo
# ----------------------------------------------------------------------
MODELS_BUDGET_S = 150            # phase 15's own limit
F32_RULE = (1e-4, 1e-5)          # rtol, atol: the port's CPU tests, f32
GRAD_RULE = (1e-3, 1e-5)         # the same tests' rule for gradients
LM_BF16_RULE = (5e-2, 5e-2)      # tests/test_archs.py's decode rule
LM_FULL_ATOL_UNITS = 4           # (b)'s atol, bf16 units of the top logit
F32_ANCHOR_FACTOR = 2.0          # (b): decode vs f32, against bf16 forward
DEEPSEEK_MAX_BYTES = 70e9        # phase 15 (c)'s peak-memory bar
MOLECULE = {"graphs": 128, "nodes": 30, "edges": 64, "species": 10}


def timed(fn):
    """``fn()`` run twice (the first warms caches and kernels up); returns
    the second result and its milliseconds, host-clocked around a
    synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def violations(got, want, rule) -> tuple[float, int]:
    """(max |got - want|, count of lanes past ``atol + rtol * |want|``),
    compared in f32."""
    g, w = got.float(), want.float()
    require(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    diff = (g - w).abs()
    return float(diff.max()), int((diff > rule[1] + rule[0] * w.abs()).sum())


def require_finite(tag: str, *tensors) -> None:
    require(all(bool(t.float().isfinite().all()) for t in tensors),
            f"{tag}: non-finite output")


def f32_config(cfg):
    """``cfg`` with its parameter and compute dtypes set to float32."""
    import dataclasses
    import torch
    names = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: torch.float32 for k in (
        "param_dtype", "compute_dtype") if k in names})


def random_csr(rng, n: int, e: int):
    """CSR (indptr, indices) and the directed edge index [2, 2e] of a
    random undirected multigraph on n nodes."""
    import numpy as np
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    order = np.argsort(ei[1], kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, ei[1] + 1, 1)
    return np.cumsum(indptr), ei[0][order], ei.astype(np.int64)


def molecules(rng, n_species: int, graphs: int, nodes: int, edges: int):
    """A disjoint union of ``graphs`` molecules of ``nodes`` atoms, each
    with its ``edges`` / 2 closest pairs as directed edges both ways."""
    import numpy as np
    pos = (rng.standard_normal((graphs, nodes, 3)) * 1.5).astype(np.float32)
    species = rng.integers(0, n_species, (graphs, nodes))
    iu = np.triu_indices(nodes, 1)
    src, dst = [], []
    for g in range(graphs):
        d = np.linalg.norm(pos[g][:, None] - pos[g][None], axis=-1)[iu]
        near = np.argsort(d, kind="stable")[:edges // 2]
        a, b = iu[0][near] + g * nodes, iu[1][near] + g * nodes
        src += [a, b]
        dst += [b, a]
    ei = np.stack([np.concatenate(src), np.concatenate(dst)])
    return species.reshape(-1), pos.reshape(-1, 3), ei


def family_inputs(family: str, cfg, rng) -> dict:
    """Numpy inputs of one smoke model: an LM's tokens, a GNN's graph,
    features and sampler blocks, a molecule, a DIN batch and user."""
    import numpy as np
    from repro_torch.data.sampler import NeighborSampler
    if family == "lm":
        toks = rng.integers(0, cfg.vocab, (2, 17))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if family == "gnn":
        indptr, indices, ei = random_csr(rng, 48, 150)
        x = rng.standard_normal((48, cfg.d_in)).astype(np.float32)
        sampler = NeighborSampler(indptr, indices, (4, 3, 2)[:cfg.n_layers],
                                  seed=3)
        feats, idx, valid = sampler.sample_padded(np.array([0, 7, 21, 40]), x)
        return {"x": x, "edge_index": ei, "feats": feats, "idx": idx,
                "valid": valid}
    if family == "equiv":
        species, pos, ei = molecules(rng, cfg.n_species, 2, 10, 30)
        return {"species": species, "positions": pos, "edge_index": ei}
    b, L = 16, cfg.seq_len
    return {"target_item": rng.integers(0, cfg.n_items, b),
            "target_cat": rng.integers(0, cfg.n_cats, b),
            "hist_items": rng.integers(0, cfg.n_items, (b, L)),
            "hist_cats": rng.integers(0, cfg.n_cats, (b, L)),
            "hist_mask": (rng.random((b, L)) < 0.7).astype(np.float32),
            "dense_feats": rng.standard_normal(
                (b, cfg.n_dense_feats)).astype(np.float32),
            "cand_items": rng.integers(0, cfg.n_items, 64),
            "cand_cats": rng.integers(0, cfg.n_cats, 64)}


def family_outputs(family: str, cfg, model, inputs: dict, dev) -> dict:
    """The family's entry points on ``dev`` -> {name: (output on the CPU,
    rule)}: an LM's logits, loss and 8 decode steps; a GNN's full and
    sampled forward; a potential's energy and forces; DIN's forward and
    candidate scores."""
    import torch
    from repro_torch.models import equivariant, gnn, recsys, transformer
    t = {k: torch.from_numpy(v).to(dev) if not isinstance(v, list)
         else [torch.from_numpy(a).to(dev) for a in v]
         for k, v in inputs.items()}
    with torch.no_grad():
        if family == "lm":
            state = transformer.init_decode_state(cfg, 2, 8, device=dev)
            steps = []
            for i in range(8):
                lg, state = transformer.lm_decode_step(
                    model, cfg, t["tokens"][:, i:i + 1], state)
                steps.append(lg[:, 0])
            out = {"logits": transformer.lm_logits(model, cfg, t["tokens"]),
                   "loss": transformer.lm_loss(model, cfg, t),
                   "decode": torch.stack(steps, 1)}
        elif family == "gnn":
            out = {"full": gnn.gnn_forward_full(model, cfg, t["x"],
                                                t["edge_index"]),
                   "sampled": gnn.gnn_forward_sampled(
                       model, cfg, t["feats"], t["idx"], t["valid"])}
        elif family == "equiv":
            e, f = equivariant.equiv_forces(model, cfg, t["species"],
                                            t["positions"], t["edge_index"])
            out = {"energy": e, "forces": f}
        else:
            user = {k: t[k][0] for k in ("hist_items", "hist_cats",
                                         "hist_mask", "dense_feats")}
            out = {"forward": recsys.din_forward(model, cfg, t),
                   "candidates": recsys.din_score_candidates(
                       model, cfg, user, t["cand_items"], t["cand_cats"])}
    return {k: (v.cpu(), GRAD_RULE if k == "forces" else F32_RULE)
            for k, v in out.items()}


def init_fn(family: str):
    from repro_torch.models import equivariant, gnn, recsys, transformer
    return {"lm": transformer.lm_init, "gnn": gnn.gnn_init,
            "equiv": equivariant.equiv_init, "recsys": recsys.din_init
            }[family]


def card_against_cpu(dev) -> dict:
    """Phase 15 (a): every arch of the registry but the matcher at its
    smoke config in float32, one set of weights drawn on the CPU and
    copied to the card, the same numpy inputs on both; the card's
    outputs must equal the CPU's within the f32 rule (forces within the
    gradient rule)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    errs = {}
    for i, (arch, spec) in enumerate(ARCHS.items()):
        if spec.family == "matcher":
            continue
        cfg = f32_config(spec.smoke_config)
        cpu_model = init_fn(spec.family)(torch.Generator().manual_seed(i),
                                         cfg, device="cpu")
        card_model = copy.deepcopy(cpu_model).to(dev)
        inputs = family_inputs(spec.family, cfg, np.random.default_rng(i))
        want = family_outputs(spec.family, cfg, cpu_model, inputs,
                              torch.device("cpu"))
        got = family_outputs(spec.family, cfg, card_model, inputs, dev)
        errs[arch] = {k: close_err(got[k][0], want[k][0], *want[k][1],
                                   tag=f"(a) {arch} {k}") for k in want}
    return errs


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_full_width_figures(model, cfg, dev, batch: int = 4,
                          prompt: int = 256, steps: int = 32,
                          forced=None) -> tuple[dict, dict]:
    """(b)'s run of ``model`` (``cfg``'s weights, on ``dev``): a ``batch``
    x ``prompt`` prefill through ``lm_decode_step``, timed after a warm-up
    at the same shape, then ``steps`` greedy decode steps (or the tokens
    ``forced`` [batch, steps] gives), and ``lm_logits`` teacher-forced on
    the same tokens in bf16 and in a float32 copy of the model. Returns
    the figures (errors under ``full_width_rule`` and under the
    reference's 5e-2, the f32 anchor) and the tensors: the fed tokens,
    the prefill and decode logits, layer 0's q, k, v on the prompt with
    the layer's own ``_sdpa`` output. Checks nothing."""
    import copy
    import numpy as np
    import torch
    from repro_torch.models import layers, transformer as T
    rng = np.random.default_rng(150)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                            ).to(dev)
    with torch.no_grad():
        warm = T.init_decode_state(cfg, batch, prompt + 1, device=dev)
        _, warm = T.lm_decode_step(model, cfg, toks, warm)
        T.lm_decode_step(model, cfg, toks[:, :1], warm)
        del warm
        state = T.init_decode_state(cfg, batch, prompt + steps, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        pre, state = T.lm_decode_step(model, cfg, toks, state)
        sync(dev)
        t1 = time.perf_counter()
        fed, outs = [toks], []
        nxt = pre[:, -1:].argmax(-1)
        for i in range(steps):
            if forced is not None:
                nxt = forced[:, i:i + 1].to(dev)
            fed.append(nxt)
            lg, state = T.lm_decode_step(model, cfg, nxt, state)
            outs.append(lg[:, 0])
            nxt = lg[:, -1:].argmax(-1)
        sync(dev)
        t2 = time.perf_counter()
        del state
        seq = torch.cat(fed, 1)
        full = T.lm_logits(model, cfg, seq)
        dec = torch.stack(outs, 1)
        finite = all(bool(t.float().isfinite().all())
                     for t in (pre, dec, full))
        rule = full_width_rule(full)
        err_pre, bad_pre = violations(pre, full[:, :prompt], rule)
        err_dec, bad_dec = violations(dec, full[:, prompt:], rule)
        _, bad_pre_ref = violations(pre, full[:, :prompt], LM_BF16_RULE)
        _, bad_ref = violations(dec, full[:, prompt:], LM_BF16_RULE)
        model32 = copy.deepcopy(model).float()
        exact = T.lm_logits(model32, f32_config(cfg), seq)[:, prompt:]
        del model32
        anchor_dec = float((dec.float() - exact).abs().max())
        anchor_fwd = float((full[:, prompt:].float() - exact).abs().max())
        del exact
        layer = model.layers[0]
        h = layers.rms_norm(T._embed_lookup(model, cfg, toks), layer.ln_attn)
        q, k, v = layers.attn_qkv(layer.attn, cfg.attn_cfg(), h,
                                  torch.arange(prompt, device=dev))
        own = layers._sdpa(q, k, v, causal=True)
    res = {"config": cfg.name, "layers": cfg.n_layers, "device": dev.type,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": batch, "prompt": prompt, "steps": steps,
           "finite": finite,
           "prefill_ms": 1e3 * (t1 - t0),
           "decode_ms_per_step": 1e3 * (t2 - t1) / steps,
           "decode_tokens_per_s": batch * steps / (t2 - t1),
           "prefill_tokens_per_s": batch * prompt / (t1 - t0),
           "rule": rule, "prefill_max_abs_err": err_pre,
           "prefill_lanes_past": bad_pre,
           "prefill_lanes_past_reference_rule": bad_pre_ref,
           "decode_max_abs_err": err_dec, "decode_lanes_past": bad_dec,
           "decode_lanes_past_reference_rule": bad_ref,
           "decode_lanes": dec.numel(),
           "max_abs_logit": float(full.float().abs().max()),
           "f32_anchor_decode_max_abs_err": anchor_dec,
           "f32_anchor_forward_max_abs_err": anchor_fwd}
    return res, {"fed": seq[:, prompt:], "prefill": pre, "decode": dec,
                 "attn": (q, k, v, own)}


def lm_full_width(dev, cfg) -> tuple[dict, tuple]:
    """Phase 15 (b): ``cfg`` whole, random bf16 weights drawn on the
    card, run by ``lm_full_width_figures``. The logits must be finite;
    the prefill's and every decode step's logits must equal ``lm_logits``
    teacher-forced on the same tokens within ``full_width_rule`` (the
    reference's rtol 5e-2, atol ``LM_FULL_ATOL_UNITS`` bf16 units of the
    largest |logit|), and the decode logits must be no further from the
    float32 model's teacher-forced logits than ``F32_ANCHOR_FACTOR``
    times the bf16 forward's own distance from them. Returns the figures
    and layer 0's q, k, v on the prompt with the layer's own ``_sdpa``
    output."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(0)
    model = T.lm_init(gen, cfg, device=dev)
    res, out = lm_full_width_figures(model, cfg, dev)
    info("models-lm-full", **res)
    require(res["finite"], "(b) logits: non-finite output")
    require(res["prefill_lanes_past"] == 0 and res["decode_lanes_past"] == 0,
            f"(b) prefill / decode logits past the rule {res['rule']}: "
            f"{res['prefill_lanes_past']} / {res['decode_lanes_past']} lanes")
    require(res["f32_anchor_decode_max_abs_err"] <= F32_ANCHOR_FACTOR
            * res["f32_anchor_forward_max_abs_err"],
            f"(b) decode {res['f32_anchor_decode_max_abs_err']} from the "
            f"f32 logits, past {F32_ANCHOR_FACTOR} x the bf16 forward's "
            f"{res['f32_anchor_forward_max_abs_err']}")
    return res, out["attn"]


def full_width_rule(logits) -> tuple[float, float]:
    """(b)'s rule: the reference's rtol, and an atol of
    ``LM_FULL_ATOL_UNITS`` bf16 units (2**-7 relative) of the largest
    |logit|, at least the reference's 5e-2."""
    unit = 2.0 ** (math.floor(math.log2(float(logits.float().abs().max())))
                   - 7)
    return (LM_BF16_RULE[0], max(LM_BF16_RULE[1], LM_FULL_ATOL_UNITS * unit))


def moe_cut_depth(dev, cfg, batch: int = 2, seq: int = 64,
                  steps: int = 8) -> dict:
    """Phase 15 (c): ``cfg`` at every published width with its depth cut,
    random bf16 weights drawn on the card. ``lm_logits`` and ``lm_loss``
    (MTP term included) on ``batch`` x ``seq`` tokens, a prefill and
    ``steps`` decode steps: all finite. Layer 0's router load on its own
    input must sum to 1; the share of (token, expert) pairs dropped at
    the configured capacity is printed, with the share of layer 0's
    input energy in its token mean and the share dropped once that mean
    is removed (and the rows renormalised). The peak allocation must
    stay under ``DEEPSEEK_MAX_BYTES``."""
    import numpy as np
    import torch
    from repro_torch.models import layers, mla, moe, transformer as T
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    model = T.lm_init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.random.default_rng(151).integers(0, cfg.vocab,
                                                (batch, seq + 1))
    batch_t = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
               "targets": torch.from_numpy(toks[:, 1:]).to(dev)}
    with torch.no_grad():
        logits, logits_ms = timed(lambda: T.lm_logits(
            model, cfg, batch_t["tokens"]))
        loss, loss_ms = timed(lambda: T.lm_loss(model, cfg, batch_t))
        layer = model.layers[0]
        x = T._embed_lookup(model, cfg, batch_t["tokens"])
        x = x + mla.mla_train_apply(layer.attn, cfg.mla,
                                    layers.rms_norm(x, layer.ln_attn),
                                    torch.arange(seq, device=dev))
        h = layers.rms_norm(x, layer.ln_ffn)
        load = moe.router_load(layer.ffn, cfg.moe, h)
        top_idx, _ = moe._route(layer.ffn, cfg.moe, h.reshape(-1, h.shape[-1]))
        cap = moe.capacity(cfg.moe, batch * seq)
        _, slot, _ = moe._dispatch_slots(top_idx, cap, cfg.moe.n_experts)
        dropped = float((slot == cfg.moe.n_experts * cap).float().mean())
        flat = h.reshape(-1, h.shape[-1]).float()
        common = flat.mean(0, keepdim=True)
        shared = float(common.square().sum() / flat.square().sum(1).mean())
        centred = flat - common
        centred = centred / centred.square().mean(-1, keepdim=True).sqrt()
        idx_c, _ = moe._route(layer.ffn, cfg.moe, centred)
        _, slot_c, _ = moe._dispatch_slots(idx_c, cap, cfg.moe.n_experts)
        dropped_c = float((slot_c == cfg.moe.n_experts * cap).float().mean())
        state = T.init_decode_state(cfg, batch, seq + steps, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre, state = T.lm_decode_step(model, cfg, batch_t["tokens"], state)
        outs = []
        nxt = pre[:, -1:].argmax(-1)
        for _ in range(steps):
            lg, state = T.lm_decode_step(model, cfg, nxt, state)
            outs.append(lg)
            nxt = lg[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
    require_finite("(c) logits, loss, decode", logits, loss, pre, *outs)
    load_sum = float(load.sum())
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"config": cfg.name, "layers": cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "tokens": [batch, seq], "init_s": init_s, "logits_ms": logits_ms,
           "loss": float(loss), "loss_ms": loss_ms,
           "prefill_and_decode_s": decode_s, "decode_steps": steps,
           "router_load_sum": load_sum, "capacity": cap,
           "capacity_factor": cfg.moe.capacity_factor,
           "dropped_share": dropped,
           "shared_component_share": shared,
           "dropped_share_token_mean_removed": dropped_c,
           "peak_bytes": peak,
           "peak_bar_bytes": DEEPSEEK_MAX_BYTES}
    info("models-moe-cut", **res)
    require(abs(load_sum - 1.0) < 1e-5, f"(c) router load sums to {load_sum}")
    require(peak < DEEPSEEK_MAX_BYTES, f"(c) peak {peak} B past the bar")
    return res


def gnn_graph(dev, g):
    """A packed data graph as the GNN's directed edge index on ``dev``
    (both directions listed, no duplicate pair)."""
    import numpy as np
    import torch
    dst = np.repeat(np.arange(g.n), np.diff(g.indptr))
    pairs = np.stack([g.indices.astype(np.int64), dst])
    require(len({(int(a), int(b)) for a, b in pairs.T}) == pairs.shape[1],
            "duplicate edge in the Cora-shaped graph")
    return torch.from_numpy(pairs).to(dev)


def families_full(dev, specs: dict, cora) -> tuple[dict, dict]:
    """Phase 15 (d): the GNNs on the Cora-shaped graph, the potentials on
    the molecule cell (energy and forces), DIN at ``serve_p99`` with its
    full tables; each at its ``FULL`` config, random weights drawn on the
    card, outputs finite, the second call timed. Returns the figures and
    gin-tu's sum aggregations of its first two layers (inputs, edges and
    ``_aggregate``'s output) for (e)."""
    import numpy as np
    import torch
    from repro_torch.models import equivariant, gnn, recsys
    gen = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(152)
    res, aggs = {}, []
    ei = gnn_graph(dev, cora)
    n = cora.n
    for arch in ("gcn-cora", "gin-tu"):
        cfg = specs[arch].config
        model = gnn.gnn_init(gen, cfg, device=dev)
        x = torch.randn((n, cfg.d_in), generator=gen, device=dev)
        with torch.no_grad():
            out, ms = timed(lambda: gnn.gnn_forward_full(model, cfg, x,
                                                              ei))
            require_finite(f"(d) {arch}", out)
            if arch == "gin-tu":
                src, dst = ei[0], ei[1]
                deg = gnn.segment_sum(torch.ones(src.shape, device=dev), dst,
                                      n)
                h = x
                for layer in model.layers[:2]:
                    agg = gnn._aggregate(h, src, dst, n, deg, cfg)
                    aggs.append((h, agg))
                    h = gnn._layer_apply(layer, cfg, h, agg, last=False)
        res[arch] = {"nodes": n, "edges": int(ei.shape[1]), "d_in": cfg.d_in,
                     "out": list(out.shape), "ms": ms}
    for arch in ("nequip", "mace"):
        cfg = specs[arch].config
        model = equivariant.equiv_init(gen, cfg, device=dev)
        species, pos, mol_ei = molecules(
            rng, MOLECULE["species"], MOLECULE["graphs"], MOLECULE["nodes"],
            MOLECULE["edges"])
        args = [torch.from_numpy(a).to(dev) for a in (species, pos, mol_ei)]
        with torch.no_grad():
            (e, f), ms = timed(lambda: equivariant.equiv_forces(
                model, cfg, *args))
        require_finite(f"(d) {arch}", e, f)
        res[arch] = {"atoms": len(species), "edges": mol_ei.shape[1],
                     "channels": cfg.channels, "energy": float(e), "ms": ms}
    cfg = specs["din"].config
    model = recsys.din_init(gen, cfg, device=dev)
    b, L = 512, cfg.seq_len                 # recsys_shapes serve_p99
    batch = {"target_item": rng.integers(0, cfg.n_items, b),
             "target_cat": rng.integers(0, cfg.n_cats, b),
             "hist_items": rng.integers(0, cfg.n_items, (b, L)),
             "hist_cats": rng.integers(0, cfg.n_cats, (b, L)),
             "hist_mask": (rng.random((b, L)) < 0.7).astype(np.float32),
             "dense_feats": rng.standard_normal(
                 (b, cfg.n_dense_feats)).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    with torch.no_grad():
        out, ms = timed(lambda: recsys.din_forward(model, cfg, batch))
    require_finite("(d) din", out)
    res["din"] = {"batch": b, "seq_len": L, "table_rows": cfg.n_items,
                  "table_bytes": model.item_table.numel() * 4, "ms": ms}
    info("models-families", **res)
    return res, {"edges": ei, "n": n, "aggs": aggs}


def kernels_against_models(dev, attn, gin, cora) -> dict:
    """Phase 15 (e): the port's attention and SpMM kernels on inputs the
    models made, against the models' own attention and aggregation (the
    models do not call the kernels): ``flash_attention_op`` on (b)'s
    layer-0 q / k / v (causal, S = T) against that layer's ``_sdpa``
    within the bf16 attention rule; ``bitmap_spmm_op`` on the Cora-shaped
    graph's packed adjacency against gin-tu's ``_aggregate`` of its first
    two layers within 1e-5. Every kernel's count set to 0 before, read
    after: one attention launch, one SpMM launch per aggregation, no
    refine."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    reset_kernel_launches()
    q, k, v, own = attn
    got = ops.flash_attention_op(*(t.transpose(1, 2).contiguous()
                                   for t in (q, k, v)), causal=True)
    atol = BF16_ATOL_UNITS * 2.0 ** -8 * own.float().abs().amax(
        -1, keepdim=True)
    errs = {"flash_attention": close_err(got.transpose(1, 2), own, 2e-2,
                                         atol, tag="(e) attention")}
    words = torch.from_numpy(np.ascontiguousarray(cora.adj_bitmap)
                             .view(np.int32)).to(dev)
    n = gin["n"]
    spmm_errs = []
    for h, agg in gin["aggs"]:
        x = torch.zeros((32 * words.shape[1], h.shape[1]), device=dev)
        x[:n] = h
        spmm_errs.append(close_err(ops.bitmap_spmm_op(words, x)[:n], agg,
                                   1e-5, 1e-5, tag="(e) SpMM"))
    errs["bitmap_spmm"] = max(spmm_errs)
    torch.cuda.synchronize()
    launches = kernel_launches()
    res = {"launches": launches, "max_abs_err": errs,
           "attention_shape": list(q.shape),
           "spmm_widths": [int(h.shape[1]) for h, _ in gin["aggs"]]}
    info("models-kernels", **res)
    require(launches == {"refine_bitmap_rows": 0,
                         "refine_bitmap_rows_hier": 0,
                         "bitmap_spmm": len(gin["aggs"]),
                         "flash_attention": 1},
            f"(e) launches {launches}: not one per call")
    return res


def kernel_launches() -> dict:
    """Every kernel's launch count, by the kernel table's names."""
    from repro_torch.kernels import bitmap_spmm, flash_attention
    refine = refine_launches()
    return {"refine_bitmap_rows": refine["dense"],
            "refine_bitmap_rows_hier": refine["hier"],
            "bitmap_spmm": bitmap_spmm.SPMM_LAUNCHES,
            "flash_attention": flash_attention.FLASH_LAUNCHES}


def reset_kernel_launches() -> None:
    from repro_torch.kernels import bitmap_spmm, flash_attention
    reset_refine_launches()
    bitmap_spmm.SPMM_LAUNCHES = flash_attention.FLASH_LAUNCHES = 0


def models_phase(dev) -> dict:
    """Phase 15: the model zoo on ``dev`` ((a)-(e) above), within
    ``MODELS_BUDGET_S``. TF32 stays off. Every kernel's count is set to 0
    before (a) and read after (d): the models' path, where each must be
    0 (``parts["path_launches"]``); (e) reads its own."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.graph_gen import er_labeled_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reset_kernel_launches()
    parts = {"a": card_against_cpu(dev)}
    info("models-card-vs-cpu", archs=len(parts["a"]), max_abs_err={
        a: max(e.values()) for a, e in parts["a"].items()})
    parts["b"], attn = lm_full_width(dev, ARCHS["qwen3-0.6b"].config)
    torch.cuda.empty_cache()
    ds = ARCHS["deepseek-v3-671b"].config
    parts["c"] = moe_cut_depth(dev, dataclasses.replace(ds, n_layers=1))
    torch.cuda.empty_cache()
    cora = er_labeled_graph(2708, 5278, 7, seed=0)  # gnn_shapes full_graph_sm
    parts["d"], gin = families_full(dev, ARCHS, cora)
    torch.cuda.synchronize()
    parts["path_launches"] = kernel_launches()
    info("models-path", launches=parts["path_launches"])
    require(not any(parts["path_launches"].values()),
            f"(a)-(d) launched a kernel: {parts['path_launches']}")
    parts["e"] = kernels_against_models(dev, attn, gin, cora)
    del attn, gin
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    info("models", seconds=seconds, within_150_s=seconds <= MODELS_BUDGET_S)
    require(seconds <= MODELS_BUDGET_S,
            f"phase 15 took {seconds:.1f} s (limit {MODELS_BUDGET_S})")
    return parts


# ----------------------------------------------------------------------
# phase 16: the training path
# ----------------------------------------------------------------------
TRAIN_BUDGET_S = 180             # phase 16's own limit
TRAIN_STEPS = 5                  # (a): steps per LM arch
GCN_STEPS = 100                  # (a): the motif GCN's steps
TRAIN_LOSS_RTOL = 1e-4           # (a): each step's loss, card vs CPU
AGREE = (1e-5, 1e-6)             # (a): rtol, atol of an agreeing weight
FLIP_SHARE = 1e-3                # (a): weights allowed past AGREE
STEP_BOUND = 1.2                 # |m_hat| / sqrt(v_hat), b1 0.9, b2 0.95
LOSS_DROP_MIN = 0.5              # (b): last 5 losses' mean below the first
FULL_TRAIN = ["--arch", "qwen3-0.6b", "--scale", "full", "--batch", "8",
              "--seq", "512", "--steps", "20", "--ckpt-every", "10",
              "--log-every", "5"]
FAIL_AT = 15


def adam_rule(got, want, lr_sum: float, wd: float) -> tuple[int, float]:
    """(weights past ``AGREE``, the largest of their differences over
    AdamW's largest two-sided move ``2 * lr_sum * (STEP_BOUND + wd *
    |w|)``; the rule holds when it is <= 1)."""
    d = (got.double() - want.double()).abs()
    past = d > AGREE[1] + AGREE[0] * want.double().abs()
    bound = 2 * lr_sum * (STEP_BOUND + wd * want.double().abs())
    worst = float((d[past] / bound[past]).max()) if past.any() else 0.0
    return int(past.sum()), worst


def rule_over(tag: str, got: dict, want: dict, lr_sum: float,
              wd: float) -> dict:
    """``adam_rule`` over two ``{name: tensor}`` mappings of one model;
    fails past it. Returns the lanes, the lanes past ``AGREE``, the worst
    ratio and the largest difference."""
    import torch
    lanes = flips = 0
    worst = err = 0.0
    for name, w in want.items():
        g, w = got[name].detach().cpu().float(), w.detach().cpu().float()
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{tag} {name}: shape or non-finite")
        n, ratio = adam_rule(g, w, lr_sum, wd)
        require(ratio <= 1.0, f"{tag} {name}: {n} weights past the rule, "
                f"worst {ratio:.3f} of AdamW's largest move")
        lanes, flips = lanes + g.numel(), flips + n
        worst = max(worst, ratio)
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    require(flips <= FLIP_SHARE * lanes,
            f"{tag}: {flips} of {lanes} weights past rtol {AGREE[0]} atol "
            f"{AGREE[1]} (at most {FLIP_SHARE})")
    return {"lanes": lanes, "past_agree": flips, "worst_of_bound": worst,
            "max_abs_err": err}


def lr_sum(ocfg, steps: int) -> float:
    from repro_torch.training.optimizer import schedule
    return float(sum(schedule(ocfg, s) for s in range(1, steps + 1)))


def bits_equal(a, b) -> bool:
    """``a`` and ``b`` hold the same dtype, shape and bits."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    a, b = (t.contiguous().view(view[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b.to(a.device)))


def trees_equal(tag: str, got, want) -> int:
    """Fails unless two trees hold the same leaves bit for bit; returns
    the leaves compared."""
    from repro_torch.training.checkpoint import tree_flatten
    (g, gdef), (w, wdef) = tree_flatten(got), tree_flatten(want)
    require(str(gdef) == str(wdef) and len(g) == len(w),
            f"{tag}: tree structures differ")
    bad = [i for i, (a, b) in enumerate(zip(g, w)) if not bits_equal(a, b)]
    require(not bad, f"{tag}: leaves {bad[:5]} differ")
    return len(g)


def lm_train_pair(dev, arch: str, seed: int, ckpt_dir: str | None) -> dict:
    """(a) for one LM arch: ``TRAIN_STEPS`` steps of ``train_step`` on the
    CPU and on ``dev`` from one set of f32 smoke weights on the same
    batches. With ``ckpt_dir``, (c): the card's (params, opt) tree saved
    there restores onto the card bit for bit."""
    import copy
    import torch
    from repro_torch import convert
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.lm_data import LMStreamConfig, TokenStream
    from repro_torch.launch.train import train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    cfg = f32_config(ARCHS[arch].smoke_config)
    ocfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                       warmup_steps=max(10, TRAIN_STEPS // 20))
    cpu = T.lm_init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    opts = [adamw_init(convert.ref_order(m), ocfg) for m in (cpu, card)]
    stream = TokenStream(LMStreamConfig(vocab=cfg.vocab, batch=2,
                                        seq_len=32, seed=seed))
    loss_err = 0.0
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 stream.next_batch().items()}
        want = float(train_step(cpu, opts[0], batch, cfg, ocfg))
        got = float(train_step(card, opts[1], {
            k: v.to(dev) for k, v in batch.items()}, cfg, ocfg))
        require(math.isfinite(got) and abs(got - want)
                <= TRAIN_LOSS_RTOL * abs(want),
                f"(a) {arch} step {step}: loss {got} on the card, {want} "
                f"on the CPU")
        loss_err = max(loss_err, abs(got - want) / abs(want))
    res = {"losses_rel_err": loss_err, "final_loss": got,
           **rule_over(f"(a) {arch}", dict(card.named_parameters()),
                       dict(cpu.named_parameters()),
                       lr_sum(ocfg, TRAIN_STEPS), ocfg.weight_decay)}
    if ckpt_dir is not None:
        tree = (convert.lm_tree(card), convert.opt_tree(opts[1], card))
        checkpoint.save(ckpt_dir, TRAIN_STEPS, tree, extra={"arch": arch})
        back, step, extra = checkpoint.restore(ckpt_dir, tree, device=dev)
        require(step == TRAIN_STEPS and extra == {"arch": arch},
                f"(c) restored step {step}, extra {extra}")
        res["c_leaves_bit_equal"] = trees_equal("(c)", back, tree)
    return res


def gcn_train_pair(dev) -> dict:
    """(a)'s motif GCN: ``GCN_STEPS`` steps of the example's loop on the
    CPU and on ``dev`` from one set of weights, motif features computed
    once on the host by the port's matcher."""
    import copy
    import importlib.util
    import numpy as np
    import torch
    from repro_torch.models import gnn
    spec = importlib.util.spec_from_file_location(
        "motif_features_gnn_torch",
        ROOT / "examples" / "motif_features_gnn_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    feats, labels, base_x, ei = ex.motif_task()
    x = np.concatenate([base_x, feats], 1)
    cfg = ex.gnn_config(x)
    cpu = gnn.gnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    want, acc_cpu = ex.train(cpu, cfg, x, ei, labels, steps=GCN_STEPS)
    got, acc = ex.train(card, cfg, x, ei, labels, steps=GCN_STEPS)
    rel = ((got.double() - want.double()).abs() / want.double().abs())
    require(bool(torch.isfinite(got).all()) and float(rel.max())
            <= TRAIN_LOSS_RTOL, f"(a) gcn: losses {float(rel.max())} apart"
            f" (rtol {TRAIN_LOSS_RTOL})")
    return {"steps": GCN_STEPS, "losses_rel_err": float(rel.max()),
            "final_loss": float(got[-1]), "acc": acc, "acc_cpu": acc_cpu,
            "triangle_vertices": int(labels.sum()),
            **rule_over("(a) gcn", dict(card.named_parameters()),
                        dict(cpu.named_parameters()),
                        lr_sum(ex.OCFG, GCN_STEPS), ex.OCFG.weight_decay)}


def train_card_against_cpu(dev) -> dict:
    """Phase 16 (a) and (c): every LM arch of the registry and the motif
    GCN, card against CPU."""
    from repro_torch.configs.registry import ARCHS
    out = {}
    with tempfile.TemporaryDirectory() as ck:
        for i, (arch, spec) in enumerate(ARCHS.items()):
            if spec.family == "lm":
                out[arch] = lm_train_pair(
                    dev, arch, i, ck if arch == "qwen3-0.6b" else None)
    out["motif-gcn"] = gcn_train_pair(dev)
    return out


class StepClock:
    """Records CUDA events around every call of the wrapped function (no
    synchronise: the driver's own ``float(loss)`` orders them), and what
    the caller keeps from each call."""

    def __init__(self, fn, keep=None):
        self.fn, self.keep, self.events, self.kept = fn, keep, [], []

    def __call__(self, *args, **kw):
        import torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        if self.keep is not None:
            self.kept.append(self.keep(out))
        return out

    def ms(self) -> list:
        import torch
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def train_full_width(dev, args=FULL_TRAIN) -> dict:
    """Phase 16 (b): ``repro_torch.launch.train.main`` at ``args`` on
    ``dev``, crashing at ``FAIL_AT`` and then resumed, with its step,
    optimizer, save and restore calls clocked; the step-10 checkpoint
    restored bit for bit against the tree the driver saved."""
    import os
    import torch
    from repro_torch.launch import train as TR
    from repro_torch.training import checkpoint
    from repro_torch.training.checkpoint import tree_flatten
    patched = {(TR, "train_step"): TR.train_step,
               (TR, "adamw_update"): TR.adamw_update,
               (checkpoint, "save"): checkpoint.save,
               (checkpoint, "restore"): checkpoint.restore}
    step_clock = StepClock(TR.train_step, keep=lambda loss: loss)
    opt_clock = StepClock(TR.adamw_update)
    saves, restores, saved = [], [], {}

    def save(ckpt_dir, step, tree, **kw):
        sync(dev)
        t0 = time.perf_counter()
        final = patched[(checkpoint, "save")](ckpt_dir, step, tree, **kw)
        saves.append({"step": step, "seconds": time.perf_counter() - t0,
                      "bytes": sum(f.stat().st_size
                                   for f in final.iterdir())})
        if step == 10 and not saved:
            saved["tree"] = tree
        return final

    def restore(*a, **kw):
        t0 = time.perf_counter()
        out = patched[(checkpoint, "restore")](*a, **kw)
        sync(dev)
        restores.append(time.perf_counter() - t0)
        return out
    TR.train_step, TR.adamw_update = step_clock, opt_clock
    checkpoint.save, checkpoint.restore = save, restore
    res: dict = {}
    try:
        with tempfile.TemporaryDirectory() as ck:
            argv = [*args, "--ckpt-dir", ck, "--device", dev.type]
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                TR.main([*argv, "--fail-at-step", str(FAIL_AT)])
            except RuntimeError as exc:
                require(str(exc) == f"injected failure at step {FAIL_AT}",
                        f"(b) the first run failed otherwise: {exc}")
            else:
                require(False, "(b) the first run did not crash")
            res["run1_seconds"] = time.perf_counter() - t0
            res["run1_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            gc.collect()
            require(checkpoint.latest_step(ck) == 10,
                    f"(b) newest checkpoint {checkpoint.latest_step(ck)}")
            back, step, _ = checkpoint.restore(ck, saved["tree"], step=10,
                                               device=dev)
            res["restored_leaves_bit_equal"] = trees_equal(
                "(b) step 10", back, saved["tree"])
            res["params"] = sum(t.numel() for t in
                                tree_flatten(saved["tree"][0])[0])
            del back, saved["tree"]
            run1 = [float(x) for x in step_clock.kept]
            n1, n1_opt = len(step_clock.events), len(opt_clock.events)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            require(TR.main(argv) == 0, "(b) the resumed run failed")
            res["run2_seconds"] = time.perf_counter() - t0
            res["run2_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            require(checkpoint.latest_step(ck) == 20,
                    f"(b) newest checkpoint {checkpoint.latest_step(ck)}")
            res["disk_free_bytes"] = os.statvfs(ck).f_bavail \
                * os.statvfs(ck).f_frsize
    finally:
        for (mod, name), fn in patched.items():
            setattr(mod, name, fn)
    run2 = [float(x) for x in step_clock.kept[n1:]]
    ms, opt_ms = step_clock.ms(), opt_clock.ms()
    losses = run1[:10] + run2
    require(len(run1) == FAIL_AT and len(run2) == 10 and
            all(math.isfinite(x) for x in run1 + run2),
            f"(b) losses {run1} then {run2}")
    drop = losses[0] - sum(losses[-5:]) / 5
    require(drop >= LOSS_DROP_MIN, f"(b) the last 5 losses' mean is "
            f"{drop:.4f} below the first (at least {LOSS_DROP_MIN})")
    steady = ms[2:n1] + ms[n1 + 2:]
    steady_opt = opt_ms[2:n1_opt] + opt_ms[n1_opt + 2:]
    tokens = int(args[args.index("--batch") + 1]) \
        * int(args[args.index("--seq") + 1])
    res.update(step_bounds(args, res.pop("params"), tokens))
    res.update({
        "losses": losses,
        "first_loss": losses[0], "last5_mean": sum(losses[-5:]) / 5,
        "loss_drop": drop, "loss_drop_min": LOSS_DROP_MIN,
        "resumed_steps_10_14_max_abs_diff": max(
            abs(a - b) for a, b in zip(run1[10:], run2[:5])),
        "ms_per_step_median": statistics.median(steady),
        "ms_first_steps": [ms[0], ms[1], ms[n1], ms[n1 + 1]],
        "tokens_per_s": tokens / (statistics.median(steady) / 1e3),
        "adamw_ms_median": statistics.median(steady_opt),
        "adamw_share": statistics.median(steady_opt)
        / statistics.median(steady),
        "saves": saves, "restore_seconds": restores})
    return res


def step_bounds(args, params: int, tokens: int) -> dict:
    """The least time of (b)'s work on the card: a step's GEMMs, 6 x
    (the parameters but the embedding table) x tokens in bf16 (no
    recomputation counted), over the bf16 peak; ``adamw_update``'s bytes,
    each parameter read and written, its gradient read and both f32
    moments read and written, over the memory rate."""
    import torch
    from repro_torch.configs.registry import get_arch
    spec = get_arch(args[args.index("--arch") + 1])
    cfg = spec.config if "full" in args else spec.smoke_config
    w = torch.empty((), dtype=cfg.param_dtype).element_size()
    opt_bytes = params * (3 * w + 4 * 4)
    flops = 6 * (params - cfg.vocab * cfg.d_model) * tokens
    return {"params": params, "tokens_per_step": tokens,
            "step_flops": flops,
            "step_bound_ms": 1e3 * flops / BF16_OPS_PER_S,
            "adamw_bytes": opt_bytes,
            "adamw_bound_ms": 1e3 * opt_bytes / HBM_BYTES_PER_S}


def train_phase(dev) -> dict:
    """Phase 16: the training path on ``dev`` ((a)-(c) above), within
    ``TRAIN_BUDGET_S``. TF32 stays off. Every kernel's count is set to 0
    before it and read after it: each must be 0 (``path_launches``)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reset_kernel_launches()
    parts = {"a": train_card_against_cpu(dev)}
    info("train-card-vs-cpu", **parts["a"])
    torch.cuda.empty_cache()
    parts["b"] = train_full_width(dev)
    info("train-full", **parts["b"])
    torch.cuda.synchronize()
    parts["path_launches"] = kernel_launches()
    info("train-path", launches=parts["path_launches"])
    require(not any(parts["path_launches"].values()),
            f"phase 16 launched a kernel: {parts['path_launches']}")
    seconds = time.perf_counter() - t0
    info("train", seconds=seconds, within_180_s=seconds <= TRAIN_BUDGET_S)
    require(seconds <= TRAIN_BUDGET_S,
            f"phase 16 took {seconds:.1f} s (limit {TRAIN_BUDGET_S})")
    return parts


# ----------------------------------------------------------------------
# phase 17: the serving examples and the step cells
# ----------------------------------------------------------------------
PHASE17_BUDGET_S = 150           # phase 17's own limit
SERVE_N_QUERIES = 30             # of the example's 50 (cut to fit 600 s)
SERVER_N_QUERIES = 8             # the --server part's (16 before phase 18)
CELL_PEAK_LIMIT = 60e9           # (b) runs a cell estimated under this
CELL_CPU_LIMIT = 8e9             # ... and against the CPU if its peak is below
PROBE_SCALE = 16                 # the peak probe's sizes: 1/16 of the cell's
SIZE_DIMS = {"full_graph": ("n_nodes", "n_edges"),   # scaled by the probe
             "sampled": ("batch_nodes",), "batched_graphs": ("batch",),
             "recsys_train": ("batch",), "recsys_serve": ("batch",),
             "recsys_retrieval": ("n_candidates",)}
MATCHER_GRAPH = {"n": 4096, "m": 3, "labels": 16, "seed": 0}
# five-vertex queries emit embeddings and store Lemma-1 patterns within
# the megastep cell's 6 iterations (eight-vertex ones reach no leaf)
MATCHER_QUERIES = {"size": 5, "seed": 7}


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_served(tag: str, rows, status: str, query, data) -> None:
    """The examples' rule: rows valid and distinct; a finished query
    gives the oracle's set, a capped one 1000 rows; a timed-out one
    valid rows only. Any other status fails."""
    from repro_torch.core.backtrack import backtrack_deadend
    require(status in ("ok", "limit", "timeout"), f"{tag}: {status}")
    require(all(valid_embedding(e, query, data) for e in rows),
            f"{tag}: invalid embedding row")
    require(len(emb_set(rows)) == len(rows), f"{tag}: duplicate embedding")
    if status == "ok":
        want = backtrack_deadend(query, data, limit=None)
        require(emb_set(rows) == emb_set(want.embeddings),
                f"{tag}: {len(rows)} rows, the oracle's set has "
                f"{want.stats.found}")
    elif status == "limit":
        require(len(rows) == 1000, f"{tag}: capped at {len(rows)} rows")


def quickstart_part(dev) -> dict:
    """``examples/quickstart_torch.py`` whole on ``dev``: the wave
    engine's embeddings on trap(100) must be the oracle's set."""
    from repro_torch.core.backtrack import backtrack_deadend
    qs = load_example("quickstart_torch")
    t0 = time.perf_counter()
    out = qs.main(["--device", dev.type])
    seconds = time.perf_counter() - t0
    trap, eng = out["trap"], out["engine"]
    oracle = backtrack_deadend(trap["query"], trap["data"], limit=None)
    require(emb_set(eng["embeddings"]) == emb_set(oracle.embeddings),
            "quickstart: the wave engine's set differs from the oracle's")
    require(out["fig1"]["found"] == 2 and trap["found"] == 200,
            f"quickstart: {out['fig1']['found']} / {trap['found']} found")
    return {"seconds": seconds, "fig1": out["fig1"]["found"],
            "trap_pruned_recursions": trap["pruned_recursions"],
            "trap_plain_recursions": trap["plain_recursions"],
            "engine": {k: eng[k] for k in ("found", "waves", "rows",
                                           "prunes")},
            "yeast": out["yeast"]}


def serve_part(dev, n_queries: int = SERVE_N_QUERIES) -> dict:
    """``examples/serve_queries_torch.py`` on ``dev`` at ``n_queries``
    (its default unless cut): every batched query by the examples' rule,
    the streamed trap query the oracle's set, the cancelled one
    ``cancelled`` with valid rows, the distributed trap(120) the
    oracle's set."""
    from repro_torch.core.backtrack import backtrack_deadend
    sq = load_example("serve_queries_torch")
    t0 = time.perf_counter()
    out = sq.main(["--device", dev.type, "--n-queries", str(n_queries)])
    seconds = time.perf_counter() - t0
    data, batch = out["data"], out["batch"]
    for i, (q, r) in enumerate(zip(batch["queries"], batch["results"])):
        check_served(f"serve q{i}", r.embeddings, r.status, q, data)
    st = out["stream"]
    check_served("stream", st["rows"], st["status"], st["query"],
                 st["data"])
    require(st["status"] == "ok", f"stream: {st['status']}")
    require(st["cancelled_status"] == "cancelled",
            f"cancelled query: {st['cancelled_status']}")
    require(all(valid_embedding(e, st["query"], st["data"])
                for e in st["cancelled_rows"]),
            "cancelled query: invalid embedding row")
    dist_ = out["distributed"]
    oracle = backtrack_deadend(dist_["query"], dist_["data"], limit=None)
    require(dist_["found"] == oracle.stats.found
            and emb_set(dist_["embeddings"]) == emb_set(oracle.embeddings),
            f"distributed trap(120): {dist_['found']} found, the oracle "
            f"{oracle.stats.found}")
    rep = batch["report"]
    statuses = [r.status for r in batch["results"]]
    return {"seconds": seconds, "n_queries": n_queries,
            "served": len(statuses), "qps": batch["qps"],
            "wall_s": batch["wall_s"], "p50_ms": rep["p50_ms"],
            "p99_ms": rep["p99_ms"], "mean_ms": rep["mean_ms"],
            "ttfe_p50_ms": rep.get("ttfe_p50_ms"),
            "timed_out": statuses.count("timeout"),
            "capped": statuses.count("limit"), "found": batch["found"],
            "engine": batch["engine"], "stream_rows": len(st["rows"]),
            "stream_ttfe_ms": 1e3 * st["ttfe_s"],
            "stream_latency_ms": 1e3 * st["latency_s"],
            "cancelled_rows": len(st["cancelled_rows"]),
            "distributed": {k: dist_[k] for k in ("found", "rows", "prunes",
                                                  "steals")}}


def example_server_part(dev) -> dict:
    """The example's ``--server`` part against ``python -m
    repro_torch.server.launch`` on ``dev`` (its default graph and
    knobs): every query by the examples' rule, the server's dense refine
    launches (two ``/metrics`` snapshots) positive, SIGTERM exit 0."""
    import os
    import signal
    from repro_torch.server.client import ServeClient
    sq = load_example("serve_queries_torch")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "repro_torch.server.launch",
           "--device", dev.type, "--port", "0", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:
        err_path = str(Path(tmp) / "server.err")
        with open(err_path, "w") as err:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=err)
        try:
            ready = wait_ready(proc, err_path, 300)
            cli = ServeClient(ready["host"], ready["port"], timeout=600)
            before = cli.metrics()["kernel_launches"]
            got = sq.main(["--server", f"{ready['host']}:{ready['port']}",
                           "--n-queries", str(SERVER_N_QUERIES)])["server"]
            after = cli.metrics()["kernel_launches"]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        err_text = Path(err_path).read_text()
    require(rc == 0, f"example server: exit {rc}: {err_text[-2000:]}")
    for i, (q, rows, res) in enumerate(zip(got["queries"], got["rows"],
                                           got["results"])):
        check_served(f"example server q{i}", rows, res["status"], q,
                     got["data"])
    launches = {k: after[k] - before[k] for k in before}
    require(launches["refine_bitmap_rows"] > 0,
            f"example server: refine launches {launches}")
    return {"seconds": time.perf_counter() - t0,
            "queries": len(got["results"]), "statuses": got["statuses"],
            "wire_qps": got["qps"], "server_launches": launches,
            "p50_ms": got["slo"].get("p50_ms"),
            "p99_ms": got["slo"].get("p99_ms")}


def examples_phase(dev) -> dict:
    """Phase 17 (a): both serving examples on ``dev``."""
    parts = {"quickstart": quickstart_part(dev)}
    info("examples-quickstart", **parts["quickstart"])
    parts["serve"] = serve_part(dev)
    info("examples-serve", **parts["serve"])
    parts["server"] = example_server_part(dev)
    info("examples-server", **parts["server"])
    return parts


def single_rank_group(dev) -> None:
    """A one-rank process group (NCCL on the card, gloo on the CPU) on a
    free local port."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


def to_device(tree, dev):
    from repro_torch.launch.sharding import tree_map
    return tree_map(lambda t: t.to(dev, copy=True), tree)


def compare_trees(tag: str, got, want, rule=F32_RULE) -> dict:
    """Every tensor lane of ``got`` (any device) against ``want``:
    integer, boolean and bitmap lanes bit for bit, float lanes within
    ``rule`` (rtol, atol). Returns the lanes compared and the largest
    float difference."""
    import torch
    from repro_torch.launch.sharding import tree_leaves_with_path
    g_leaves = dict(tree_leaves_with_path(got))
    w_leaves = dict(tree_leaves_with_path(want))
    require(set(g_leaves) == set(w_leaves), f"{tag}: output trees differ")
    worst = 0.0
    for path, w in w_leaves.items():
        g = g_leaves[path].detach().cpu()
        w = w.detach().cpu()
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{tag} {path}: {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        if w.is_floating_point():
            require_finite(f"{tag} {path}", g)
            err, bad = violations(g, w, rule)
            require(bad == 0, f"{tag} {path}: {bad} lanes past {rule}, "
                    f"max |diff| {err:.3g}")
            worst = max(worst, err)
        else:
            require(bool(torch.equal(g, w)), f"{tag} {path}: lanes differ")
    return {"lanes": len(w_leaves), "max_abs_err": worst}


def matcher_cells(dev, mesh) -> dict:
    """Phase 17 (b), the matcher cells at their published shapes, on real
    banks: a 4096-vertex power-law graph and 16 five-vertex queries
    through ``steps.matcher_args``. The stack cell runs first; its Δ
    store after the run is the wave cell's input store. Each runs on
    ``dev`` and on the CPU (plain refine), every lane bit for bit; the
    card run's dense refine launches must be positive. Step times: the
    median of 3 calls on fresh copies of the inputs."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graph_gen import powerlaw_graph, query_set
    from repro_torch.launch import steps
    g = MATCHER_GRAPH
    data = powerlaw_graph(g["n"], g["m"], g["labels"], seed=g["seed"])
    spec = get_arch("paper-matcher")
    out, store = {}, None
    for shape in ("yeast_scale_stacks", "yeast_scale"):
        dims = spec.shape(shape).dims
        queries = query_set(data, MATCHER_QUERIES["size"], dims["n_slots"],
                            seed=MATCHER_QUERIES["seed"])
        cell = steps.build_cell("paper-matcher", shape, mesh)
        args = steps.matcher_args(dims, data, queries, device="cpu")
        if store is not None:
            args = args[:2] + (store,) + args[3:]
        t0 = time.perf_counter()
        want = cell.fn(*to_device(args, torch.device("cpu")))
        cpu_s = time.perf_counter() - t0
        before = refine_launches()
        got = cell.fn(*to_device(args, dev))
        sync(dev)
        launches = {k: v - before[k] for k, v in refine_launches().items()}
        require(launches["dense"] > 0 and launches["hier"] == 0,
                f"{shape}: refine launches {launches}")
        res = compare_trees(shape, got, want)
        times = []
        for _ in range(3):
            fresh = to_device(args, dev)
            sync(dev)
            t0 = time.perf_counter()
            cell.fn(*fresh)
            sync(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        if shape == "yeast_scale_stacks":
            store = want.tb
            res.update(expanded=int(want.d_expanded.sum()),
                       rows=int(want.d_rows.sum()),
                       prunes=int(want.d_prunes.sum()),
                       stored=int(want.d_stored.sum()),
                       embeddings=int(want.n_emb))
        else:
            res.update(children=int(want[0].n_children.sum()),
                       prunes=int(want[0].n_pruned.sum()))
        out[shape] = {**res, "launches": launches["dense"],
                      "step_ms": statistics.median(times), "cpu_s": cpu_s,
                      "arg_bytes": cell.arg_bytes()}
        info(f"cells-{shape}", **out[shape])
    return out


def max_f32_leaf(tree) -> int:
    from repro_torch.launch.sharding import tree_leaves_with_path
    return max(4 * t.numel() for _, t in tree_leaves_with_path(tree))


def probe_excess(spec, shape, mesh, dev) -> float:
    """Bytes a call of the cell at 1/``PROBE_SCALE`` of its sizes
    allocates beyond its arguments (the card's peak-memory counter);
    infinite if the probe itself runs out of memory."""
    import dataclasses
    import torch
    from repro_torch.launch import steps
    dims = {k: (max(1, v // PROBE_SCALE) if k in SIZE_DIMS[shape.kind]
                else v) for k, v in shape.dims.items()}
    small = dataclasses.replace(shape, dims=dims)
    cell = steps.build_cell_of(spec, small, mesh)
    args = steps.example_args(spec, small, cell, seed=3, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    try:
        cell.fn(*args)
        torch.cuda.synchronize()
        excess = float(torch.cuda.max_memory_allocated() - before)
    except torch.OutOfMemoryError:
        excess = math.inf
    del cell, args
    gc.collect()
    torch.cuda.empty_cache()
    return excess


def model_cells(dev, mesh, peak_limit=CELL_PEAK_LIMIT,
                cpu_limit=CELL_CPU_LIMIT) -> dict:
    """Phase 17 (b), the GNN, equivariant and DIN cells. Each cell's
    estimated peak: its argument bytes plus, for a train step, its
    gradients and six f32 copies of its largest leaf (AdamW's per-leaf
    temporaries); past ``peak_limit`` it does not fit. Else a probe at
    1/``PROBE_SCALE`` of its sizes measures what a call allocates beyond
    its arguments, and the estimate adds ``PROBE_SCALE`` times that.
    A cell estimated under ``peak_limit`` runs on ``dev`` with random
    inputs (``steps.example_args``): finite outputs, and, if the card's
    measured peak is at most ``cpu_limit``, every output lane against
    the CPU's run of the same inputs (copied before the card's run, which
    updates donated arguments in place) by the f32 rule."""
    import torch
    from repro_torch.configs.registry import all_cells, get_arch
    from repro_torch.launch import steps
    out, skipped = {}, {}
    for arch, shape_name in all_cells():
        spec = get_arch(arch)
        if spec.family == "lm":
            continue
        shape = spec.shape(shape_name)
        cell = steps.build_cell(arch, shape_name, mesh)
        name = f"{arch}/{shape_name}"
        nbytes = cell.arg_bytes()
        est = nbytes
        if cell.donate:
            est += (steps.tree_bytes(cell.args[0])
                    + 6 * max_f32_leaf(cell.args[0]))
        if est <= peak_limit and dev.type == "cuda":
            est += PROBE_SCALE * probe_excess(spec, shape, mesh, dev)
        if est > peak_limit:
            skipped[name] = {"arg_bytes": nbytes, "est_peak_bytes": est}
            continue
        args = steps.example_args(spec, shape, cell, seed=17, device=dev)
        cpu_args = to_device(args, torch.device("cpu"))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = cell.fn(*args)
        sync(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else est)
        on_cpu = peak <= cpu_limit
        row = {"arg_bytes": nbytes, "est_peak_bytes": est,
               "peak_bytes": peak, "ms": ms, "cpu_checked": on_cpu}
        if on_cpu:
            t0 = time.perf_counter()
            want = cell.fn(*cpu_args)
            row["cpu_s"] = time.perf_counter() - t0
            row.update(compare_trees(name, got, want))
        else:
            from repro_torch.launch.sharding import tree_leaves_with_path
            require_finite(name, *(t for _, t in tree_leaves_with_path(got)
                                   if t.is_floating_point()))
        out[name] = row
        del got, args, cpu_args
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"ran": out, "not_fitting": skipped}


def cells_phase(dev, peak_limit=CELL_PEAK_LIMIT,
                cpu_limit=CELL_CPU_LIMIT) -> dict:
    """Phase 17 (b): every cell built at mesh (1, 1) over a one-rank
    process group on ``dev``, its argument bytes printed; the matcher
    cells and the model cells that fit (the LM cells run in phase 18)."""
    import torch.distributed as dist
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch import mesh as meshes, steps
    single_rank_group(dev)
    try:
        mesh = meshes.make_host_test_mesh((1, 1))
        info("cells-bytes", **{f"{a}/{s}": steps.build_cell(a, s, mesh)
                               .arg_bytes()
                               for a, s in all_cells(include_matcher=True)})
        parts = {"matcher": matcher_cells(dev, mesh)}
        parts["models"] = model_cells(dev, mesh, peak_limit, cpu_limit)
        info("cells-models", **parts["models"])
    finally:
        dist.destroy_process_group()
    return parts


def examples_cells_phase(dev) -> dict:
    """Phase 17: (a) the serving examples and (b) the step cells on
    ``dev``, within ``PHASE17_BUDGET_S``. Every kernel's count is set to
    0 before (a) and read after (b) (``path_launches``); the dense
    refine's must be positive."""
    import torch
    t0 = time.perf_counter()
    reset_kernel_launches()
    parts = {"a": examples_phase(dev)}
    parts["b"] = cells_phase(dev)
    sync(dev)
    parts["path_launches"] = kernel_launches()
    info("slice8-path", launches=parts["path_launches"])
    require(parts["path_launches"]["refine_bitmap_rows"] > 0,
            f"phase 17: no dense refine launch: {parts['path_launches']}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    info("slice8", seconds=seconds,
         within_150_s=seconds <= PHASE17_BUDGET_S)
    require(seconds <= PHASE17_BUDGET_S,
            f"phase 17 took {seconds:.1f} s (limit {PHASE17_BUDGET_S})")
    return parts


# ----------------------------------------------------------------------
# phase 18: the models' mesh paths (the LM step cells at mesh (1, 1))
# ----------------------------------------------------------------------
PHASE18_BUDGET_S = 90            # phase 18's own limit
QWEN_CELLS = {                   # (kind, dims): each cut named in PERF.md
    "train_4k": ("train", {"global_batch": 2, "seq_len": 4096}),
    "prefill_32k": ("prefill", {"global_batch": 1, "seq_len": 8192}),
    "decode_32k": ("decode", {"global_batch": 4, "kv_len": 32768}),
    "long_500k": ("decode", {"global_batch": 1, "kv_len": 131072})}
DEEPSEEK_CELLS = {
    "prefill_32k": ("prefill", {"global_batch": 1, "seq_len": 4096}),
    "decode_32k": ("decode", {"global_batch": 32, "kv_len": 32768}),
    "train_4k": ("train", {"global_batch": 1, "seq_len": 2048})}
DEEPSEEK_EXPERT_CHOICES = (256, 128, 64, 32, 16, 8)   # train_4k's cut
CELL_EST_MAX_BYTES = 70e9        # a cell runs if its estimate is below
SMOKE_CELLS = {"train": {"global_batch": 2, "seq_len": 16},
               "prefill": {"global_batch": 2, "seq_len": 16},
               "decode": {"global_batch": 2, "kv_len": 16}}
QWEN_LOGIT_ATOL_UNITS = 2        # mesh vs local path, bf16 units of max|logit|


def lm_cell_spec(arch: str, n_layers=None, n_experts=None, smoke=False):
    """The arch's spec with its config cut: ``n_layers``, ``n_experts``,
    or the float32 smoke config."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    spec = get_arch(arch)
    cfg = f32_config(spec.smoke_config) if smoke else spec.config
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts))
    return dataclasses.replace(spec, config=cfg)


def estimated_bytes(cell, kind: str) -> float:
    """A cell's arguments, plus for a train step its gradients and seven
    float32 copies of its largest leaf (AdamW's per-leaf temporaries)."""
    from repro_torch.launch import steps
    est = cell.arg_bytes()
    if kind == "train":
        params = cell.args[0]
        est += steps.tree_bytes(params) + 7 * 4 * max(
            t.numel() for _, t in steps.tree_leaves_with_path(params))
    return float(est)


def deepseek_train_experts(mesh) -> tuple[int, float]:
    """The largest expert count of ``DEEPSEEK_EXPERT_CHOICES`` whose
    one-layer ``train_4k`` cell (at its cut dims) is estimated under
    ``CELL_EST_MAX_BYTES``, and that estimate."""
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import steps
    kind, dims = DEEPSEEK_CELLS["train_4k"]
    for e in DEEPSEEK_EXPERT_CHOICES:
        spec = lm_cell_spec("deepseek-v3-671b", n_layers=1, n_experts=e)
        cell = steps.build_cell_of(spec, ShapeCell("train_4k", kind, dims),
                                   mesh)
        est = estimated_bytes(cell, kind)
        if est <= CELL_EST_MAX_BYTES:
            return e, est
    raise SmokeFailure("no expert count of deepseek train_4k fits")


class DropCounter:
    """Counts the pairs ``moe._local_sort_dispatch`` drops at capacity
    (real keys whose slot is the trash slot), by stage: the send stage
    then the expert stage of each layer's call."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe._local_sort_dispatch
        self.kept = [0, 0]
        self.total = [0, 0]
        self.calls = 0

    def __enter__(self):
        def spy(flat, keys, n_buckets, cap):
            out = self.real(flat, keys, n_buckets, cap)
            stage = self.calls % 2
            real = keys >= 0
            self.total[stage] += int(real.sum())
            self.kept[stage] += int((out[2] < n_buckets * cap).sum())
            self.calls += 1
            return out
        self.moe._local_sort_dispatch = spy
        return self

    def __exit__(self, *exc):
        self.moe._local_sort_dispatch = self.real

    def share(self) -> float:
        """Dropped (token, expert) pairs over all pairs routed."""
        return 1.0 - self.kept[1] / max(1, self.total[0])


def run_lm_cell(dev, mesh, spec, name: str, kind: str, dims: dict,
                seed: int, local=None, drops: bool = False) -> dict:
    """One LM cell of ``spec`` at ``dims`` on ``dev``: its bytes reckoned
    first (refused past ``CELL_EST_MAX_BYTES``), arguments drawn on the
    card (``steps.example_args``) and placed on ``mesh`` as ``DTensor``s
    by the cell's specs (``sharding.distribute``: on one rank, without a
    copy), a first call (checked: finite; its result gathered whole by
    ``sharding.full`` against ``local``, the port's local path on the
    same arguments, where given) and a timed second call.
    ``peak_bytes`` is the first call's peak
    (read before the checks, whose float copies of the outputs are
    larger than the path's own temporaries), ``live_bytes`` what was
    allocated when it started: the arguments and the local path's
    output."""
    import torch
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import sharding, steps
    shape = ShapeCell(name, kind, dims)
    cell = steps.build_cell_of(spec, shape, mesh)
    est = estimated_bytes(cell, kind)
    require(est <= CELL_EST_MAX_BYTES,
            f"{spec.arch_id}/{name}: estimated {est:.3g} B")
    row = {"dims": dims, "arg_bytes": cell.arg_bytes(), "est_bytes": est,
           "base_bytes": torch.cuda.memory_allocated()}
    args = steps.example_args(spec, shape, cell, seed=seed, device=dev)
    want = local(cell, args) if local is not None else None
    args = sharding.distribute(args, cell.in_specs, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row["live_bytes"] = torch.cuda.memory_allocated()
    counter = DropCounter() if drops else None
    if counter is not None:
        with counter:
            out = cell.fn(*args)
        row["dropped_share"] = counter.share()
        row["routed_pairs"] = counter.total[0]
    else:
        out = cell.fn(*args)
    torch.cuda.synchronize()
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    out = sharding.full(out)
    floats = [t for _, t in sharding.tree_leaves_with_path(out)
              if t.is_floating_point()]
    require_finite(f"{spec.arch_id}/{name}", *floats)
    if kind == "train":
        row["loss"] = float(out[2])
    if want is not None:
        got = {"train": lambda: out[2], "prefill": lambda: out,
               "decode": lambda: out[0]}[kind]()
        if kind == "train":
            err = abs(float(got) - float(want))
            require(err <= 1e-4 * abs(float(want)),
                    f"qwen3 {name}: mesh loss {float(got)} vs local "
                    f"{float(want)}")
        else:
            atol = QWEN_LOGIT_ATOL_UNITS * float(want.float().abs().max()) \
                / 128
            err, bad = violations(got, want, (0.0, atol))
            require(bad == 0, f"qwen3 {name}: {bad} logits past {atol:.3g}")
        row["vs_local_max_abs_err"] = err
    del out, want
    t0 = time.perf_counter()
    cell.fn(*args)
    torch.cuda.synchronize()
    row["ms"] = 1e3 * (time.perf_counter() - t0)
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return row


def qwen_local(kind: str, cfg):
    """The port's local path (``cfg``, without mesh fields) on a cell's
    arguments, for the mesh path at (1, 1) to equal: the loss of a train
    step, the logits of a prefill, the logits of a decode step (on a copy
    of the state, which the step writes)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    @torch.no_grad()
    def local(cell, args):
        model = steps.bind_lm(cfg, args[0])
        if kind == "train":
            return T.lm_loss(model, cfg, args[2])
        if kind == "prefill":
            return T.lm_logits(model, cfg, args[1])
        state = args[1]
        copy = {"cache": tuple(t.clone() for t in state["cache"]),
                "length": int(state["length"])}
        return T.lm_decode_step(model, cfg, args[2], copy)[0]
    return local


def mesh_cells_cpu_run(out_path: str) -> int:
    """Phase 18's CPU side, in its own process: the deepseek smoke cells
    (float32) over a one-rank gloo group on the CPU; writes their
    outputs."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import mesh as meshes, sharding, steps
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            mesh = meshes.make_host_test_mesh((1, 1))
            spec = lm_cell_spec("deepseek-v3-671b", smoke=True)
            out = {}
            for kind, dims in SMOKE_CELLS.items():
                shape = ShapeCell(kind, kind, dims)
                cell = steps.build_cell_of(spec, shape, mesh)
                args = steps.example_args(spec, shape, cell, seed=18,
                                          device="cpu")
                out[kind] = sharding.full(cell.fn(*sharding.distribute(
                    args, cell.in_specs, mesh)))
        finally:
            dist.destroy_process_group()
    torch.save(out, out_path)
    return 0


def deepseek_smoke_against_cpu(dev, mesh, cpu_out: dict) -> dict:
    """The deepseek smoke cells (float32) on the card against the same
    cells' outputs on the CPU (``mesh_cells_cpu_run``), every lane by the
    f32 rule (``F32_RULE``), each run on ``DTensor`` arguments and gathered
    whole."""
    from repro_torch.configs.common import ShapeCell
    from repro_torch.launch import sharding, steps
    spec = lm_cell_spec("deepseek-v3-671b", smoke=True)
    res = {}
    for kind, dims in SMOKE_CELLS.items():
        shape = ShapeCell(kind, kind, dims)
        cell = steps.build_cell_of(spec, shape, mesh)
        args = to_device(steps.example_args(spec, shape, cell, seed=18,
                                            device="cpu"), dev)
        got = sharding.full(cell.fn(*sharding.distribute(
            args, cell.in_specs, mesh)))
        res[kind] = compare_trees(f"deepseek smoke {kind}", got,
                                  cpu_out[kind])
    return res


def mesh_paths_phase(dev) -> dict:
    """Phase 18: the 20 LM cells' mesh paths at mesh (1, 1) over a
    one-rank NCCL group, within ``PHASE18_BUDGET_S``: qwen3-0.6b's four
    cells at full width (every layer), each against the port's local path
    on the same arguments; deepseek-v3-671b's prefill and decode at full
    width cut to one layer, and its train step also cut to the largest
    expert count whose estimate fits; the deepseek smoke cells against
    the CPU. Each cell's arguments are ``DTensor``s placed by its specs
    (``sharding.distribute``), as on any mesh. Every kernel's count is
    set to 0 before and read after: the reference's models are plain
    jnp, so each must stay 0."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshes
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cpu_path = str(Path(tmp) / "mesh_cells_cpu.pt")
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "--mesh-cpu-run", cpu_path],
                                stdout=subprocess.DEVNULL)
        try:
            single_rank_group(dev)
            try:
                mesh = meshes.make_host_test_mesh((1, 1))
                reset_kernel_launches()
                parts = {"qwen3": {}, "deepseek": {}}
                qwen = lm_cell_spec("qwen3-0.6b")
                for i, (name, (kind, dims)) in enumerate(QWEN_CELLS.items()):
                    parts["qwen3"][name] = run_lm_cell(
                        dev, mesh, qwen, name, kind, dims, seed=180 + i,
                        local=qwen_local(kind, qwen.config))
                    info(f"mesh-qwen3-{name}", **parts["qwen3"][name])
                e, e_est = deepseek_train_experts(mesh)
                for i, (name, (kind, dims)) in enumerate(
                        DEEPSEEK_CELLS.items()):
                    spec = lm_cell_spec("deepseek-v3-671b", n_layers=1,
                                        n_experts=e if kind == "train"
                                        else None)
                    row = run_lm_cell(dev, mesh, spec, name, kind, dims,
                                      seed=190 + i, drops=True)
                    row["n_experts"] = spec.config.moe.n_experts
                    parts["deepseek"][name] = row
                    info(f"mesh-deepseek-{name}", **row)
                torch.cuda.synchronize()
                parts["path_launches"] = kernel_launches()
                rc = proc.wait()
                require(rc == 0, f"the CPU side failed (exit code {rc})")
                parts["smoke"] = deepseek_smoke_against_cpu(
                    dev, mesh, torch.load(cpu_path))
                info("mesh-deepseek-smoke-vs-cpu", **parts["smoke"])
            finally:
                dist.destroy_process_group()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    info("slice9-path", launches=parts["path_launches"],
         deepseek_train_experts=e, deepseek_train_est_bytes=e_est)
    require(not any(parts["path_launches"].values()),
            f"phase 18 launched a kernel: {parts['path_launches']}")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    info("slice9", seconds=seconds,
         within_90_s=seconds <= PHASE18_BUDGET_S)
    require(seconds <= PHASE18_BUDGET_S,
            f"phase 18 took {seconds:.1f} s (limit {PHASE18_BUDGET_S})")
    return parts


# ----------------------------------------------------------------------
def warm_up(dev, wl) -> None:
    """CUDA context and first launches of both kernels' paths, outside
    every counted run."""
    from repro_torch.data.graph_gen import powerlaw_graph, query_set
    from repro_torch.serving import QueryServer
    serve(dev, {"corridor": wl["corridor"]})
    small = powerlaw_graph(512, 3, 4, seed=1)
    QueryServer(small, backend="engine", device=dev, hier_adjacency=True
                ).submit_batch(query_set(small, 4, 2, seed=1))


def plain_run(out_path: str) -> int:
    """Phase 4, in its own process: every workload with the plain
    refines forced on the card. Writes the run's digest and summary."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import bitmap_refine
    from repro_torch.kernels.config import backend_scope
    dev = torch.device("cuda")
    wl = workloads()
    with backend_scope("torch"):
        warm_up(dev, wl)
        run = serve(dev, wl)
    require(all(r["launches"] == {"dense": 0, "hier": 0}
                for r in run.values()),
            "a kernel launched under backend_scope('torch')")
    with open(out_path, "wb") as f:
        pickle.dump({"digest": run_digest(run),
                     "summary": run_summary(run)}, f)
    return 0


def start_plain_run(out_path: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--plain-run", out_path],
                            stdout=subprocess.DEVNULL)


def finish_plain_run(proc: subprocess.Popen, out_path: str) -> dict:
    rc = proc.wait()
    require(rc == 0, f"the plain-refine run failed (exit code {rc})")
    with open(out_path, "rb") as f:
        return pickle.load(f)


TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def kernel_row(name, source, replaces, launches, worst, timing,
               slice6, slice7, slice8, slice9, cases=None) -> dict:
    """One row of the kernel table: ``launches`` from the main path's
    run, the times and bound from ``timing`` (one case's), the error the
    worst of the checks; ``slice6`` the kernel's launches in phase 15,
    ``path`` in the models' run (a)-(d) and ``check`` in (e); ``slice7``
    its launches in phase 16, ``slice8`` in phase 17, ``slice9`` in
    phase 18; ``cases`` adds every timed case's numbers."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": max(worst, timing.get("max_abs_err", 0)),
           **{k: timing.get(k) for k in TIMING_KEYS},
           "slice6_path_launches": slice6["path"],
           "slice6_check_launches": slice6["check"],
           "slice7_path_launches": slice7,
           "slice8_path_launches": slice8,
           "slice9_path_launches": slice9}
    if "launch_floor_ms" in timing:
        row["launch_floor_ms"] = timing["launch_floor_ms"]
    if cases:
        row["cases"] = {c: {k: t.get(k) for k in TIMING_KEYS + (
            "route", "gathered_bytes")} for c, t in cases.items()}
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # plain versions and yardsticks in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    info("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    info("build", **build_kernels())

    with tempfile.TemporaryDirectory() as tmp:
        plain_path = str(Path(tmp) / "plain_run.pkl")
        proc = start_plain_run(plain_path)
        try:
            wl = workloads()
            human, scale = wl["human"][0], wl["scale"][0]
            cases = kernel_cases(human.adj_bitmap.view("int32"))
            hcases = hier_cases(scale)
            worst = check_kernel(dev, cases)
            worst_hier = check_hier_kernel(dev, hcases)
            warm_up(dev, wl)
            samples: list = []
            hier_samples: list = []
            run_k = serve(dev, wl, capture={
                "human": ("refine_bitmap_rows", sampler(samples, 3)),
                "scale": ("refine_bitmap_rows_hier",
                          sampler(hier_samples, 3))})
            launches = check_launches(run_k)
            check_answers(run_k, wl)
            info("serve-kernel", launches=launches, **run_summary(run_k))
            plain = finish_plain_run(proc, plain_path)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    same_runs(run_digest(run_k), plain["digest"])
    info("serve-plain", identical=True, **plain["summary"])

    info("hier-vs-dense", **hier_against_dense(hier_samples, scale))
    floor = launch_floor_ms(dev)
    timing = {**time_kernel(samples), "launch_floor_ms": floor}
    info("kernel-time", **timing)
    timing_hier = {**time_hier_kernel(hier_samples),
                   "launch_floor_ms": floor}
    info("hier-kernel-time", **timing_hier)
    for name in ("human", "scale"):
        prof = profile_window(dev, wl, name)
        if prof["profiled"]:
            r = run_k[name]
            wall_ms = 1e3 * r["wall_s"] / max(1, r["iterations"])
            prof["main_run_wall_ms_per_iteration"] = wall_ms
            prof["device_busy_share_est"] = \
                prof["device_ms_per_iteration"] / wall_ms
        info(f"profile-{name}", **prof)
    t_ops = time.perf_counter()
    spmm, flash, bad_blocks = op_cases(dev, wl)
    refine_args = [torch.from_numpy(a).to(dev) for a in cases[0][1:]]
    _, lanes, kmax, *refine_rows = hcases[0]
    hier_args = [*(torch.from_numpy(a).to(dev) for a in lanes), kmax,
                 *(torch.from_numpy(a).to(dev) for a in refine_rows)]
    op_run = drive_ops(spmm, flash, bad_blocks, refine_args, hier_args)
    op_launches = op_run["launches"]
    info("ops-run", launches=op_launches, spmm_calls=len(spmm),
         spmm_routes=op_run["spmm_routes"],
         flash_calls=len(flash), flash_routes=op_run["flash_routes"],
         bad_blocks_raised=len(bad_blocks))
    worst_ops = check_ops(op_run, spmm, flash, refine_args, hier_args)
    del op_run
    op_timing = time_ops(spmm, flash)
    ops_seconds = time.perf_counter() - t_ops
    del spmm, flash
    torch.cuda.empty_cache()
    t_ft = time.perf_counter()
    base_human = run_k["human"]["results"]
    fault_phase(dev, wl, base_human[:N_FAULT_QUERIES],
                [len(r.embeddings) for r in base_human[:N_FAULT_QUERIES]])
    distributed_phase(dev, wl, base_human, run_k["scale"]["results"])
    ft_seconds = time.perf_counter() - t_ft
    info("faults-distributed", seconds=ft_seconds,
         within_120_s=ft_seconds <= 120)
    t_ts = time.perf_counter()
    tuner_phase(dev)
    server_phase(dev, wl, run_k["scale"]["results"])
    ts_seconds = time.perf_counter() - t_ts
    info("tuner-server", seconds=ts_seconds, within_120_s=ts_seconds <= 120)
    del samples, hier_samples, refine_args, hier_args
    gc.collect()
    torch.cuda.empty_cache()
    t_models = time.perf_counter()
    models = models_phase(dev)
    slice6 = {name: {"path": models["path_launches"][name],
                     "check": models["e"]["launches"][name]}
              for name in models["path_launches"]}
    models_seconds = time.perf_counter() - t_models
    gc.collect()
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    slice7 = train_phase(dev)["path_launches"]
    train_seconds = time.perf_counter() - t_train
    gc.collect()
    torch.cuda.empty_cache()
    t_slice8 = time.perf_counter()
    slice8 = examples_cells_phase(dev)["path_launches"]
    slice8_seconds = time.perf_counter() - t_slice8
    gc.collect()
    torch.cuda.empty_cache()
    t_slice9 = time.perf_counter()
    slice9 = mesh_paths_phase(dev)["path_launches"]
    slice9_seconds = time.perf_counter() - t_slice9
    rows = [kernel_row("refine_bitmap_rows",
                       "src/repro_torch/kernels/csrc/bitmap_refine.cu",
                       "src/repro/kernels/bitmap_refine.py:100",
                       launches["dense"], worst, timing,
                       slice6["refine_bitmap_rows"],
                       slice7["refine_bitmap_rows"],
                       slice8["refine_bitmap_rows"],
                       slice9["refine_bitmap_rows"]),
            kernel_row("refine_bitmap_rows_hier",
                       "src/repro_torch/kernels/csrc/bitmap_refine_hier.cu",
                       "src/repro/kernels/bitmap_refine.py:323",
                       launches["hier"], worst_hier, timing_hier,
                       slice6["refine_bitmap_rows_hier"],
                       slice7["refine_bitmap_rows_hier"],
                       slice8["refine_bitmap_rows_hier"],
                       slice9["refine_bitmap_rows_hier"]),
            kernel_row("bitmap_spmm",
                       "src/repro_torch/kernels/csrc/bitmap_spmm.cu",
                       "src/repro/kernels/bitmap_spmm.py:68",
                       op_launches["bitmap_spmm"], worst_ops["bitmap_spmm"],
                       op_timing["a human f32"], slice6["bitmap_spmm"],
                       slice7["bitmap_spmm"], slice8["bitmap_spmm"],
                       slice9["bitmap_spmm"],
                       {c: op_timing[c] for c in SPMM_TIMED}),
            kernel_row("flash_attention",
                       "src/repro_torch/kernels/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:99",
                       op_launches["flash_attention"],
                       worst_ops["flash_attention"],
                       op_timing["a prefill bf16"],
                       slice6["flash_attention"],
                       slice7["flash_attention"],
                       slice8["flash_attention"],
                       slice9["flash_attention"])]
    seconds = time.perf_counter() - t_start
    info("done", seconds=seconds, ops_seconds=ops_seconds,
         faults_distributed_seconds=ft_seconds,
         tuner_server_seconds=ts_seconds, models_seconds=models_seconds,
         train_seconds=train_seconds, slice8_seconds=slice8_seconds,
         slice9_seconds=slice9_seconds, within_600_s=seconds <= 600)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--plain-run"]:
            sys.exit(plain_run(sys.argv[2]))
        if sys.argv[1:2] == ["--mesh-cpu-run"]:
            sys.exit(mesh_cells_cpu_run(sys.argv[2]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
