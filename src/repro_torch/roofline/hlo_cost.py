"""Per-device cost of one run of a step cell (twin of
``repro.roofline.hlo_cost``, whose name it keeps).

No HLO is parsed here: torch compiles no whole-program HLO. Instead the
cell's ``fn`` runs once on ``meta`` tensors (shapes only, no memory, no
arithmetic) placed on the production mesh over a fake process group,
and a dispatch mode counts every op that runs on this rank's shards:

  * FLOPs       — products and attention by
                  ``torch.utils.flop_counter``'s formulas (2·M·N·K a
                  product), plus 1 flop an output element for pointwise
                  ops and reductions (the reference's documented
                  approximation: products dominate).
  * HBM bytes   — input bytes + output bytes of every op that is not a
                  view (an eager op reads its inputs from and writes its
                  outputs to memory; there is no fusion to hide them).
  * collectives — result bytes per kind of every functional collective
                  (all-reduce, all-gather, reduce-scatter, all-to-all),
                  the ``shard_map`` bodies' and those DTensor inserts,
                  and their number (``CommDebugMode``).
  * memory      — this rank's argument shards plus the most bytes the
                  run held at once: each non-view op's output counts
                  from its making until the last tensor that views it
                  is freed (eager lifetimes, saved activations
                  included; ``empty*`` ops, DTensor's shape inference,
                  hold nothing). Filled in as ``mem_per_device_bytes``,
                  where the reference puts its compiler's memory plan.
  * custom-call — the reference's Pallas custom-calls. The port's
                  CUDA kernels are not torch ops and run on no cell's
                  path under a dry-run (``meta`` tensors reach the plain
                  versions), so these fields stay 0.

An op on ``DTensor``s is not counted itself: the local ops DTensor runs
for it are (``CommDebugMode``, inside the counter, takes the DTensor
op; what it runs reaches the counter). ``unresolved_loops`` stays 0:
an eager run unrolls every loop, so there is no trip count to resolve.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
               "_softmax", "_log_softmax", "cumsum", "prod", "var", "std",
               "norm", "linalg_vector_norm", "_softmax_backward_data",
               "_log_softmax_backward_data", "topk", "sort", "argsort"}
_FREE = {"detach", "alias", "wait_tensor", "lift_fresh", "_local_scalar_dense",
         "empty", "empty_like", "empty_strided"}


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    custom_call_bytes: float = 0.0
    custom_call_count: int = 0
    coll_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    unresolved_loops: int = 0
    coll_count: int = 0
    peak_bytes: float = 0.0      # arguments + the most held at once


class _Block:
    """The bytes of one op's output, held while a tensor refers to it."""

    def __init__(self, counter, n: int):
        self.counter, self.n = counter, n
        counter.live += n
        counter.peak = max(counter.peak, counter.live)

    def __del__(self):
        self.counter.live -= self.n


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Counter(TorchDispatchMode):
    """Counts the ops run under it into ``self.cost``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.cost = HloCost()
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.live = self.peak = 0
        self.blocks = WeakIdKeyDictionary()      # tensor -> its _Block

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, (DTensor, FakeTensor)) for t in ins):
            # a DTensor op (its local ops are counted) or DTensor's own
            # shape inference on fake tensors, which runs no device work
            return out
        outs = _tensors(out)
        self._hold(func, ins, outs)
        self._count(func, ins, outs, args, kwargs, out)
        return out

    def _hold(self, func, ins, outs) -> None:
        """A view holds its base's block; any other output not among the
        inputs (in place) holds a new block of its bytes, but for the
        ``_FREE`` ops (``empty*`` are DTensor's shape inference)."""
        if func._overloadpacket.__name__ in _FREE:
            return
        if func.is_view:
            base = self.blocks.get(ins[0]) if ins else None
            if base is not None:
                for o in outs:
                    self.blocks[o] = base
            return
        for o in outs:
            if not any(o is t for t in ins):
                self.blocks[o] = _Block(self, o.numel() * o.element_size())

    def _count(self, func, ins, outs, args, kwargs, out) -> None:
        c = self.cost
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional") and name in _KIND:
            b = _nbytes(outs)
            c.coll_by_kind[_KIND[name]] += b
            c.coll_bytes += b
            c.bytes += b + _nbytes(ins)
            return
        if func.is_view or name in _FREE or ns in ("_c10d_functional",
                                                   "c10d_functional"):
            return
        c.bytes += _nbytes(ins) + _nbytes(outs)
        packet = func._overloadpacket
        if packet in self.flop_registry:
            c.flops += self.flop_registry[packet](*args, **kwargs,
                                                  out_val=out)
        elif outs and (torch.Tag.pointwise in func.tags
                       or name.rstrip("_") in _REDUCTIONS):
            c.flops += outs[0].numel()


def count_run(fn, *args) -> HloCost:
    """The per-device cost of ``fn(*args)`` on this rank (run once)."""
    from torch.distributed.tensor.debug import CommDebugMode
    counter = _Counter()
    # CommDebugMode inside: it takes each DTensor op, and the local ops
    # DTensor runs for it reach the counter outside
    with counter, CommDebugMode() as comm:
        fn(*args)
    counter.cost.coll_count = comm.get_total_counts()
    shards = [t.to_local() if isinstance(t, DTensor) else t
              for t in _tensors(args)]
    counter.cost.peak_bytes = float(_nbytes(shards) + counter.peak)
    return counter.cost
