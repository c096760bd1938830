"""CLI-parseable server configuration of the port (DESIGN.md §10) — the sglang
``ServerArgs`` idiom: one dataclass that owns every launch knob, with
``add_cli_args``/``from_cli_args`` so ``python -m repro_torch.server.launch
--help`` is the single source of truth.

Engine knobs deliberately mirror :class:`repro_torch.api.MatchOptions` names
and default to ``None`` = "resolve through MatchOptions > tuning cache
> built-in" (DESIGN.md §9) — a launched server picks up the same tuned
configuration the benchmarks were measured with unless the operator
pins a knob explicitly.

Tenant admission config is JSON (inline or ``@file.json``):

    --tenants '{"alpha": {"rate": 50, "burst": 8, "weight": 2},
                "beta":  {"rate": 10}}'

Unknown tenants get the ``--default-*`` policy (their own bucket and
queue). The data graph is built in-process from a named generator —
the serving tier serves one resident graph, like the engine below it.
``--device`` (default ``cuda``) places the engine; ``cpu`` runs the
plain versions on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Any

from ..api.options import MatchOptions
from .admission import TenantConfig

__all__ = ["ServerArgs", "GRAPH_KINDS"]

GRAPH_KINDS = ("ba", "er", "powerlaw", "yeast", "trap", "corridor")

# ServerArgs fields forwarded verbatim into MatchOptions.resolve()
_ENGINE_KNOBS = ("n_slots", "wave_size", "kpr", "megastep_depth",
                 "max_queue", "limit", "time_budget_s", "max_recursions",
                 "pattern_capacity", "shed_policy", "stack_capacity")


@dataclasses.dataclass
class ServerArgs:
    # ---- network ------------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 8421               # 0 = pick a free port (announced)

    # ---- data graph ---------------------------------------------------
    graph: str = "ba"
    graph_n: int = 512
    graph_seed: int = 0
    graph_labels: int = 24
    graph_m: int = 3               # BA/powerlaw attachment degree
    graph_extra_edges: int = 512   # ba generator densification

    # ---- engine (None = MatchOptions > tuning cache > built-in) -------
    backend: str = "engine"        # "engine" | "sequential"
    device: str = "cuda"           # the engine's device ("cpu" for tests)
    n_slots: int | None = None
    wave_size: int | None = None
    kpr: int | None = None
    megastep_depth: int | None = None
    max_queue: int | None = None
    limit: int | None = 1000
    time_budget_s: float | None = 10.0
    max_recursions: int | None = None
    pattern_capacity: int | None = None
    stack_capacity: int | None = None
    shed_policy: str | None = None   # engine-level QueueFull policy

    # ---- tenants ------------------------------------------------------
    tenants: str | None = None     # JSON object or @path
    default_rate: float | None = None   # None = unlimited
    default_burst: float = 8.0
    default_weight: float = 1.0
    default_max_pending: int = 256

    # ---- lifecycle ----------------------------------------------------
    warmup_queries: int = 4        # engine warmup before listening
    warmup_query_size: int = 4
    drain_timeout_s: float = 60.0  # SIGTERM: max wait for residents
    idle_poll_s: float = 0.002     # engine-thread sleep when idle
    metrics_refresh_s: float = 0.25

    # ------------------------------------------------------------------
    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        d = ServerArgs()
        net = ap.add_argument_group("network")
        net.add_argument("--host", default=d.host)
        net.add_argument("--port", type=int, default=d.port,
                         help="0 picks a free port (announced on the "
                              "READY line)")
        g = ap.add_argument_group("data graph")
        g.add_argument("--graph", choices=GRAPH_KINDS, default=d.graph)
        g.add_argument("--graph-n", type=int, default=d.graph_n)
        g.add_argument("--graph-seed", type=int, default=d.graph_seed)
        g.add_argument("--graph-labels", type=int, default=d.graph_labels)
        g.add_argument("--graph-m", type=int, default=d.graph_m)
        g.add_argument("--graph-extra-edges", type=int,
                       default=d.graph_extra_edges)
        e = ap.add_argument_group(
            "engine (unset = MatchOptions > tuning cache > built-in)")
        e.add_argument("--backend", choices=("engine", "sequential"),
                       default=d.backend)
        e.add_argument("--device", default=d.device,
                       help="the engine's device: cuda (default) or cpu")
        for knob, typ in (("n_slots", int), ("wave_size", int),
                          ("kpr", int), ("megastep_depth", int),
                          ("max_queue", int), ("limit", int),
                          ("time_budget_s", float),
                          ("max_recursions", int),
                          ("pattern_capacity", int),
                          ("stack_capacity", int)):
            e.add_argument(f"--{knob.replace('_', '-')}", type=typ,
                           default=getattr(d, knob))
        e.add_argument("--shed-policy", choices=("reject", "shed_lowest"),
                       default=d.shed_policy)
        t = ap.add_argument_group("tenants")
        t.add_argument("--tenants", default=d.tenants,
                       help="JSON object name -> {rate, burst, weight, "
                            "max_pending}, or @path/to/file.json")
        t.add_argument("--default-rate", type=float, default=d.default_rate)
        t.add_argument("--default-burst", type=float,
                       default=d.default_burst)
        t.add_argument("--default-weight", type=float,
                       default=d.default_weight)
        t.add_argument("--default-max-pending", type=int,
                       default=d.default_max_pending)
        lc = ap.add_argument_group("lifecycle")
        lc.add_argument("--warmup-queries", type=int,
                        default=d.warmup_queries)
        lc.add_argument("--warmup-query-size", type=int,
                        default=d.warmup_query_size)
        lc.add_argument("--drain-timeout-s", type=float,
                        default=d.drain_timeout_s)

    @staticmethod
    def from_cli_args(ns: argparse.Namespace) -> "ServerArgs":
        fields = {f.name for f in dataclasses.fields(ServerArgs)}
        return ServerArgs(**{k: v for k, v in vars(ns).items()
                             if k in fields})

    # ------------------------------------------------------------------
    def build_graph(self):
        """Build the resident data graph from the named generator —
        deterministic in (kind, n, seed), so a client-side oracle can
        reconstruct the identical graph."""
        from ..data import graph_gen as gg
        k = self.graph
        if k == "ba":
            return gg.ba_labeled_graph(
                self.graph_n, self.graph_m, self.graph_labels,
                extra_edges=self.graph_extra_edges, seed=self.graph_seed)
        if k == "er":
            return gg.er_labeled_graph(
                self.graph_n, self.graph_extra_edges, self.graph_labels,
                seed=self.graph_seed)
        if k == "powerlaw":
            return gg.powerlaw_graph(self.graph_n, self.graph_m,
                                     self.graph_labels,
                                     seed=self.graph_seed)
        if k == "yeast":
            return gg.yeast_like_graph(self.graph_seed)
        if k == "trap":
            _, g = gg.trap_graph(seed=self.graph_seed)
            return g
        if k == "corridor":
            _, g = gg.corridor_graph(seed=self.graph_seed)
            return g
        raise ValueError(f"unknown graph kind {self.graph!r}")

    def build_options(self) -> MatchOptions:
        knobs: dict[str, Any] = {}
        for k in _ENGINE_KNOBS:
            v = getattr(self, k)
            if v is not None:
                knobs[k] = v
        return MatchOptions.resolve(None, **knobs)

    def build_tenants(self) -> tuple[dict[str, TenantConfig],
                                     TenantConfig]:
        """Parse ``--tenants`` into per-tenant configs + the default
        policy applied to tenants not named there."""
        default = TenantConfig(
            name="default", rate=self.default_rate,
            burst=self.default_burst, weight=self.default_weight,
            max_pending=self.default_max_pending).validate()
        if not self.tenants:
            return {}, default
        raw = self.tenants
        if raw.startswith("@"):
            raw = pathlib.Path(raw[1:]).read_text()
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"--tenants is not valid JSON: {e}") from e
        if not isinstance(spec, dict):
            raise ValueError("--tenants must be a JSON object "
                             "{name: {rate, burst, weight, max_pending}}")
        tenants = {}
        for name, cfg in spec.items():
            if not isinstance(cfg, dict):
                raise ValueError(f"tenant {name!r} config must be an "
                                 "object")
            bad = set(cfg) - {"rate", "burst", "weight", "max_pending"}
            if bad:
                raise ValueError(f"tenant {name!r}: unknown keys {bad}")
            tenants[name] = TenantConfig(
                name=name, rate=cfg.get("rate", default.rate),
                burst=cfg.get("burst", default.burst),
                weight=cfg.get("weight", default.weight),
                max_pending=cfg.get("max_pending",
                                    default.max_pending)).validate()
        return tenants, default
