"""Deterministic fault injection for the matching runtime (DESIGN.md §8).

Twin of ``repro/core/faults.py``. A :class:`FaultPlan` is a seeded list
of :class:`FaultSpec` triggers aimed at the runtime's failure
boundaries — dispatch, digest, flush, admission, checkpoint, shard. The
scheduler / distributed matcher poke the plan at each boundary crossing
(``plan.poke(site, ...)``); when a spec's trigger count is reached the
corresponding failure is injected *on the host side*, so every chaos
scenario is reproducible without touching the kernels:

=============  =====================================================
site           kinds
=============  =====================================================
``dispatch``   ``exception`` (dispatch raises before the device
               call), ``hang`` (dispatch is marked hung; the
               watchdog treats the digest as untrusted)
``digest``     ``corrupt`` (bit-flip a digest lane past a validator
               invariant), ``overflow`` (forge a stack-capacity
               overflow for one slot)
``flush``      ``exception`` (a Δ pattern flush batch is dropped —
               sound: patterns only ever prune)
``admission``  ``exception`` (admission of one request fails)
``checkpoint`` ``exception`` (one checkpoint save fails)
``shard``      ``shard_loss`` (a distributed shard dies mid-run)
=============  =====================================================

Counters are 1-based and per-site: ``FaultSpec(site, kind, at=3)``
fires on the third crossing of ``site``; ``times=2`` keeps firing for
two consecutive crossings (e.g. ``times > dispatch_retries`` exhausts
the retry budget). Fired specs are appended to ``plan.fired`` so tests
and chaos runs can assert exactly which faults landed.

All hooks are gated on ``plan is None`` in the callers, so the
disabled path costs one attribute load.

**What the dispatch retry loop recovers from** (:data:`DISPATCH_ERRORS`)
is the one deliberate difference from the reference, which also retries
JAX's runtime error. Here it is the injected fault and
``torch.OutOfMemoryError``, and nothing else. A CUDA launch or
illegal-address error, a kernel build failure, or any other
``RuntimeError`` / ``torch.AcceleratorError`` propagates out of
``step()``: a sticky CUDA error cannot be retried in the same context,
and catching it would hide a fault of a kernel behind a replay on the
degraded path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["FaultSpec", "FaultPlan", "FaultInjected", "corrupt_digest",
           "DISPATCH_ERRORS", "DISPATCH_SITE", "DIGEST_SITE",
           "FLUSH_SITE", "ADMISSION_SITE", "CHECKPOINT_SITE",
           "SHARD_SITE"]

DISPATCH_SITE = "dispatch"
DIGEST_SITE = "digest"
FLUSH_SITE = "flush"
ADMISSION_SITE = "admission"
CHECKPOINT_SITE = "checkpoint"
SHARD_SITE = "shard"

_SITES = (DISPATCH_SITE, DIGEST_SITE, FLUSH_SITE, ADMISSION_SITE,
          CHECKPOINT_SITE, SHARD_SITE)
_KINDS = {
    DISPATCH_SITE: ("exception", "hang"),
    DIGEST_SITE: ("corrupt", "overflow"),
    FLUSH_SITE: ("exception",),
    ADMISSION_SITE: ("exception",),
    CHECKPOINT_SITE: ("exception",),
    SHARD_SITE: ("shard_loss",),
}


class FaultInjected(RuntimeError):
    """Raised (or recorded) when a planned fault fires."""


# exception types the dispatch retry loop treats as recoverable (see the
# module docstring for why no other runtime error is among them)
DISPATCH_ERRORS: tuple = (FaultInjected, torch.OutOfMemoryError)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned failure: fires on crossings ``at .. at+times-1`` of
    ``site`` (1-based). ``slot`` aims digest faults at a specific
    device slot (None = first slot in the digest's slot map)."""
    site: str
    kind: str
    at: int = 1
    slot: int | None = None
    times: int = 1

    def __post_init__(self):
        if self.site not in _SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {_SITES}")
        if self.kind not in _KINDS[self.site]:
            raise ValueError(
                f"fault kind {self.kind!r} invalid for site "
                f"{self.site!r}; expected one of {_KINDS[self.site]}")
        if self.at < 1 or self.times < 1:
            raise ValueError("FaultSpec.at and .times must be >= 1")


class FaultPlan:
    """A deterministic, stateful schedule of :class:`FaultSpec`.

    ``poke(site, **ctx)`` advances the site's crossing counter and
    returns the matching spec if one fires (else None). ``fired``
    records ``(site, kind, crossing, ctx)`` tuples in firing order.
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...] = (),
                 seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.counts: dict[str, int] = {}
        self.fired: list[tuple[str, str, int, dict]] = []

    def poke(self, site: str, **ctx: Any) -> FaultSpec | None:
        """Advance ``site``'s crossing counter; return the firing spec
        (first match wins) or None."""
        n = self.counts.get(site, 0) + 1
        self.counts[site] = n
        for spec in self.specs:
            if spec.site == site and spec.at <= n < spec.at + spec.times:
                self.fired.append((site, spec.kind, n, dict(ctx)))
                return spec
        return None

    def peek(self, site: str) -> int:
        """Crossing count so far for ``site`` (no advance)."""
        return self.counts.get(site, 0)

    def reset(self) -> None:
        self.counts.clear()
        self.fired.clear()


def corrupt_digest(dig: dict, spec: FaultSpec, *, stack_capacity: int,
                   slots: list[int]) -> int:
    """Deterministically corrupt one slot's lanes in a materialized
    (host-side numpy) digest dict so a validator invariant is violated.

    ``kind="corrupt"`` breaks Lemma-4 outstanding-counter conservation
    and forges a negative counter; ``kind="overflow"`` forges a live
    count past ``stack_capacity``. Returns the corrupted slot."""
    slot = spec.slot if spec.slot is not None else slots[0]
    if spec.kind == "overflow":
        dig["d_live"][slot] = stack_capacity + 1 + (spec.at % 7)
        dig["d_pending"][slot] = stack_capacity + 1
    else:
        # flip a high bit in the conservation lane and go negative in a
        # counter lane — either alone trips the validator
        dig["d_outsum"][slot] = dig["d_outsum"][slot] ^ (1 << 20)
        dig["d_rows"][slot] = -1
    return slot
