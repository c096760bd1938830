"""The port's network serving tier (``repro_torch.server``) on the CPU.

Three parts:

* one port case for each test of ``tests/test_server.py``: wire
  round-trips and strict decoding, multi-tenant admission (WFQ, token
  buckets, bounded-queue shedding), and end to end over HTTP against a
  port server subprocess (``--device cpu``): streamed embeddings equal
  to the sequential oracle's sets, a client disconnect cancelling its
  query through the eviction path without disturbing co-resident ones,
  the ``/slo`` and ``/metrics`` shapes;
* differential checks against ``repro.server``: the same request or
  event encodes to the same bytes in both packages and decodes in the
  other, the admission controllers give the same order and shedding for
  the same offers, the server arguments build the same graphs, and the
  reference's ``ServeClient`` gets the oracle's sets from the port's
  server;
* the drain: SIGTERM refuses new requests with a typed ``draining``
  event, lets the resident query finish, and exits 0.

Every wait has a timeout.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

from repro.core.backtrack import backtrack_deadend as ref_backtrack
from repro.core.graph import Graph as RefGraph
from repro.server import admission as ref_admission
from repro.server import protocol as ref_protocol
from repro.server.client import ServeClient as RefClient
from repro.server.server_args import ServerArgs as RefArgs
from repro_torch.api.handle import STATUSES
from repro_torch.api.session import MatchSession
from repro_torch.core.graph import Graph
from repro_torch.data.graph_gen import ba_labeled_graph, query_set
from repro_torch.server import protocol
from repro_torch.server.admission import (AdmissionController,
                                          TenantConfig, TokenBucket)
from repro_torch.server.client import ServeClient, ServerError
from repro_torch.server.protocol import (MatchRequestWire, ProtocolError,
                                         decode_event, decode_query,
                                         done_event, encode_event,
                                         encode_query)
from repro_torch.server import launch
from repro_torch.server.server import MatchServer
from repro_torch.server.server_args import GRAPH_KINDS, ServerArgs

ROOT = Path(__file__).resolve().parent.parent
WAIT_S = 180


def embset(embs):
    return set(frozenset(enumerate(np.asarray(e).tolist())) for e in embs)


def rowset(rows):
    return set(frozenset(enumerate(r)) for r in rows)


def oracle(q, data, limit=None):
    """The reference's sequential oracle (``repro.core.backtrack``) on
    the same graphs."""
    def ref(g):
        return RefGraph(g.n, g.labels, g.indptr, g.indices, g.n_labels)
    return ref_backtrack(ref(q), ref(data), limit=limit)


# ======================================================================
# protocol: versioned JSON wire encoding
# ======================================================================
def _tiny_query() -> Graph:
    return Graph.from_edges(3, [(0, 1), (1, 2)], [0, 1, 0], n_labels=2)


def test_query_roundtrip():
    q = _tiny_query()
    d = encode_query(q)
    q2 = decode_query(d)
    assert encode_query(q2) == d


def test_request_roundtrip():
    wire = MatchRequestWire(query=_tiny_query(), tenant="alpha",
                            options={"limit": 10, "priority": 3},
                            request_id="req-7")
    back = MatchRequestWire.from_json(wire.to_json())
    assert back.tenant == "alpha"
    assert back.options == {"limit": 10, "priority": 3}
    assert back.request_id == "req-7"
    assert encode_query(back.query) == encode_query(wire.query)


def test_every_terminal_status_survives_the_wire():
    assert set(STATUSES) == {"ok", "limit", "timeout", "cancelled",
                             "error", "shed"}
    for st in STATUSES:
        ev = done_event(7, {"status": st, "n_embeddings": 0})
        back = decode_event(encode_event(ev))
        assert back == ev
        assert back["result"]["status"] == st


def test_done_event_rejects_non_terminal_status():
    with pytest.raises(ProtocolError):
        done_event(7, {"status": "running"})


def _valid_request() -> dict:
    return MatchRequestWire(query=_tiny_query()).to_wire()


@pytest.mark.parametrize("mutate", [
    pytest.param(lambda p: p.pop("v"), id="missing-version"),
    pytest.param(lambda p: p.update(v=99), id="wrong-version"),
    pytest.param(lambda p: p.pop("query"), id="missing-query"),
    pytest.param(lambda p: p["query"].update(n=0), id="n-zero"),
    pytest.param(lambda p: p["query"].update(n=65), id="n-too-big"),
    pytest.param(lambda p: p["query"].update(n="3"), id="n-not-int"),
    pytest.param(lambda p: p["query"].update(labels=[0, 1]),
                 id="labels-wrong-length"),
    pytest.param(lambda p: p["query"].update(labels=[0, -1, 0]),
                 id="negative-label"),
    pytest.param(lambda p: p["query"]["edges"].append([2, 2]),
                 id="self-loop"),
    pytest.param(lambda p: p["query"]["edges"].append([0, 3]),
                 id="edge-out-of-range"),
    pytest.param(lambda p: p["query"]["edges"].append([0]),
                 id="edge-not-a-pair"),
    pytest.param(lambda p: p["query"].update(n_labels=1),
                 id="n_labels-below-max-label"),
    pytest.param(lambda p: p.update(options={"wave_size": 9}),
                 id="engine-knob-not-settable"),
    pytest.param(lambda p: p.update(options={"limit": [1]}),
                 id="option-not-a-scalar"),
    pytest.param(lambda p: p.update(tenant=""), id="empty-tenant"),
    pytest.param(lambda p: p.update(tenant=7), id="tenant-not-str"),
    pytest.param(lambda p: p.update(request_id={"a": 1}),
                 id="request_id-not-scalar"),
])
def test_malformed_request_rejected(mutate):
    """Rejected by the port, and by the reference alike."""
    payload = _valid_request()
    mutate(payload)
    raw = json.dumps(payload)
    with pytest.raises(ProtocolError):
        MatchRequestWire.from_json(raw)
    with pytest.raises(ref_protocol.ProtocolError):
        ref_protocol.MatchRequestWire.from_json(raw)


def test_request_not_json_rejected():
    with pytest.raises(ProtocolError):
        MatchRequestWire.from_json(b"{nope")


@pytest.mark.parametrize("line", [
    pytest.param('{"v": 1, "event": "nope"}', id="unknown-kind"),
    pytest.param('{"event": "done"}', id="event-missing-version"),
    pytest.param('{"v": 1, "event": "chunk", "seq": -1, "rows": []}',
                 id="negative-seq"),
    pytest.param('{"v": 1, "event": "chunk", "seq": 0, "rows": [[1.5]]}',
                 id="non-int-rows"),
    pytest.param('{"v": 1, "event": "done", "result": '
                 '{"status": "running"}}', id="done-non-terminal"),
    pytest.param('{"v": 1, "event": "error", "message": "x"}',
                 id="error-missing-code"),
    pytest.param("{not json", id="not-json"),
])
def test_malformed_event_rejected(line):
    with pytest.raises(ProtocolError):
        decode_event(line)
    with pytest.raises(ref_protocol.ProtocolError):
        ref_protocol.decode_event(line)


# ---- the same bytes in both packages ---------------------------------
def _wire_cases():
    data = ba_labeled_graph(60, 3, 4, extra_edges=40, seed=5)
    qs = query_set(data, 5, 4, seed=2) + [_tiny_query()]
    opts = [{}, {"limit": None}, {"limit": 10, "priority": 3},
            {"time_budget_s": 2.5, "use_pruning": False},
            {"max_recursions": 100, "parallelism": 2}]
    return [(q, o, rid) for q, o, rid in
            zip(qs, opts, [None, 7, "req-x", 0, "y"])]


@pytest.mark.parametrize("i", range(5))
def test_request_bytes_equal_the_reference(i):
    """A request encoded by either package decodes in the other and
    re-encodes to the same bytes."""
    q, opts, rid = _wire_cases()[i]
    port = MatchRequestWire(query=q, tenant="alpha", options=opts,
                            request_id=rid).to_json()
    ref_q = RefGraph.from_edges(q.n, [tuple(e) for e in
                                      encode_query(q)["edges"]],
                                q.labels.tolist(), n_labels=q.n_labels)
    ref = ref_protocol.MatchRequestWire(query=ref_q, tenant="alpha",
                                        options=opts,
                                        request_id=rid).to_json()
    assert port == ref
    assert ref_protocol.MatchRequestWire.from_json(port).to_json() == port
    assert MatchRequestWire.from_json(ref).to_json() == ref


def test_event_bytes_equal_the_reference():
    evs = [(protocol.accepted_event(3, "alpha", "r"),
            ref_protocol.accepted_event(3, "alpha", "r")),
           (protocol.chunk_event(3, 0, np.arange(8).reshape(2, 4)),
            ref_protocol.chunk_event(3, 0, np.arange(8).reshape(2, 4))),
           (protocol.error_event("draining", code="draining"),
            ref_protocol.error_event("draining", code="draining"))]
    evs += [(done_event(3, {"status": st, "n_found": 1}),
             ref_protocol.done_event(3, {"status": st, "n_found": 1}))
            for st in STATUSES]
    for port, ref in evs:
        b = encode_event(port)
        assert b == ref_protocol.encode_event(ref)
        assert ref_protocol.encode_event(ref_protocol.decode_event(b)) == b
        assert encode_event(decode_event(b)) == b
    assert protocol.WIRE_VERSION == ref_protocol.WIRE_VERSION == 1
    assert protocol.REQUEST_OPTION_KEYS == ref_protocol.REQUEST_OPTION_KEYS


# ======================================================================
# admission: WFQ, token buckets, bounded-queue shedding
# ======================================================================
def _item(priority=0, name=""):
    return types.SimpleNamespace(priority=priority, name=name)


def test_wfq_shares_interleave_by_weight():
    ctl = AdmissionController({
        "alpha": TenantConfig(weight=2.0),
        "beta": TenantConfig(weight=1.0)})
    for i in range(6):
        ctl.offer(_item(name=f"a{i}"), "alpha")
    for i in range(3):
        ctl.offer(_item(name=f"b{i}"), "beta")
    order = [ctl.next_ready().name[0] for _ in range(9)]
    assert order == ["a", "a", "b"] * 3
    assert ctl.next_ready() is None


def test_token_bucket_rate_and_burst():
    b = TokenBucket(rate=10.0, burst=2.0, now=0.0)
    assert b.take(0.0) and b.take(0.0)
    assert not b.take(0.0)
    assert not b.peek(0.05)
    assert b.peek(0.1) and b.take(0.1)
    assert not b.take(0.1)
    unlimited = TokenBucket(rate=None, burst=1.0, now=0.0)
    assert all(unlimited.take(0.0) for _ in range(100))


def test_over_rate_tenant_waits_without_blocking_others():
    ctl = AdmissionController({
        "slow": TenantConfig(rate=0.001, burst=1.0),
        "fast": TenantConfig()})
    ctl.offer(_item(name="s0"), "slow")
    ctl.offer(_item(name="s1"), "slow")
    ctl.offer(_item(name="f0"), "fast")
    got = {ctl.next_ready().name, ctl.next_ready().name}
    assert got == {"s0", "f0"}
    assert ctl.next_ready() is None
    assert ctl.snapshot()["slow"]["pending"] == 1


def test_bounded_queue_sheds_lowest_priority():
    shed = []
    ctl = AdmissionController(
        {"t": TenantConfig(max_pending=2)}, on_shed=shed.append)
    ctl.offer(_item(priority=1, name="p1"), "t")
    ctl.offer(_item(priority=2, name="p2"), "t")
    assert ctl.offer(_item(priority=0, name="p0"), "t") is False
    assert [it.name for it in shed] == ["p0"]
    assert ctl.offer(_item(priority=3, name="p3"), "t") is True
    assert [it.name for it in shed] == ["p0", "p1"]
    assert ctl.snapshot()["t"]["shed"] == 2
    kept = {ctl.next_ready().name, ctl.next_ready().name}
    assert kept == {"p2", "p3"}


def test_requeue_front_counts_backpressure_not_shed():
    ctl = AdmissionController({"t": TenantConfig()})
    ctl.offer(_item(name="x"), "t")
    ctl.offer(_item(name="y"), "t")
    it = ctl.next_ready()
    assert it.name == "x"
    ctl.requeue_front(it, "t")
    snap = ctl.snapshot()["t"]
    assert snap["backpressure"] == 1
    assert snap["admitted"] == 0
    assert snap["shed"] == 0
    assert ctl.next_ready().name == "x"
    assert ctl.next_ready().name == "y"


@pytest.mark.parametrize("seed", range(4))
def test_admission_equals_the_reference(seed):
    """The same offers, pops and requeues (rate-free tenants, so the
    clock cannot differ) give the same admission order, the same shed
    items and the same counters in both packages."""
    rng = np.random.default_rng(seed)
    tenants = {"alpha": dict(weight=2.0, max_pending=6),
               "beta": dict(weight=1.0, max_pending=4),
               "gamma": dict(weight=0.5, max_pending=3)}
    ops = []
    for n in range(120):
        r = rng.random()
        if r < 0.6:
            ops.append(("offer", str(rng.choice(list(tenants) + ["new"])),
                        int(rng.integers(0, 4)), n))
        elif r < 0.93:
            ops.append(("pop",))
        else:
            ops.append(("requeue",))

    def run(mod):
        shed = []
        ctl = mod.AdmissionController(
            {k: mod.TenantConfig(**v) for k, v in tenants.items()},
            mod.TenantConfig(max_pending=2),
            on_shed=lambda it: shed.append(it.name))
        trace, last = [], None
        for op in ops:
            if op[0] == "offer":
                _, t, prio, n = op
                it = types.SimpleNamespace(priority=prio, name=n, tenant=t)
                trace.append(("offer", ctl.offer(it, t)))
            elif op[0] == "pop":
                last = ctl.next_ready()
                trace.append(("pop", None if last is None else last.name))
            elif last is not None:
                ctl.requeue_front(last, last.tenant)
                last = None
        while (it := ctl.next_ready()) is not None:
            trace.append(("pop", it.name))
        snap = {k: {c: v for c, v in s.items()} for k, s in
                ctl.snapshot().items()}
        return trace, shed, snap

    assert run(sys.modules[AdmissionController.__module__]) == \
        run(ref_admission)


# ======================================================================
# server arguments
# ======================================================================
def test_server_args_device_and_graphs_equal_the_reference():
    import argparse
    ap = argparse.ArgumentParser()
    ServerArgs.add_cli_args(ap)
    assert ServerArgs().device == "cuda"
    args = ServerArgs.from_cli_args(ap.parse_args(["--device", "cpu",
                                                   "--graph", "er"]))
    assert args.device == "cpu" and args.graph == "er"
    opts = args.build_options()
    assert opts.limit == 1000 and opts.time_budget_s == 10.0
    assert set(GRAPH_KINDS) == set(
        __import__("repro.server.server_args",
                   fromlist=["x"]).GRAPH_KINDS)
    for kind in ("ba", "er", "powerlaw", "trap", "corridor"):
        kw = dict(graph=kind, graph_n=80, graph_seed=2, graph_labels=5,
                  graph_extra_edges=60)
        g, r = ServerArgs(**kw).build_graph(), RefArgs(**kw).build_graph()
        assert g.n == r.n and g.n_labels == r.n_labels, kind
        for a in ("labels", "indptr", "indices"):
            assert np.array_equal(getattr(g, a), getattr(r, a)), kind
    tenants, default = ServerArgs(
        tenants=json.dumps({"alpha": {"weight": 2}})).build_tenants()
    assert tenants["alpha"].weight == 2 and default.name == "default"
    with pytest.raises(ValueError, match="unknown keys"):
        ServerArgs(tenants='{"a": {"speed": 1}}').build_tenants()


# ======================================================================
# a failing engine step: every request learns it at once
# ======================================================================
SMALL = dict(n=48, m=3, labels=3, extra=48, seed=3)
DEVICE_FAULT = "CUDA error: an illegal memory access was encountered"


def _small_graph():
    return ba_labeled_graph(SMALL["n"], SMALL["m"], SMALL["labels"],
                            extra_edges=SMALL["extra"], seed=SMALL["seed"])


def _device_fault(*args, **kwargs):
    raise RuntimeError(DEVICE_FAULT)


def _assert_error_stream(events):
    assert events[0]["event"] == "accepted"
    done = events[-1]
    assert done["event"] == "done" and done["result"]["status"] == "error"
    assert DEVICE_FAULT in done["result"]["error"]


def test_engine_step_failure_ends_every_request(monkeypatch):
    """An exception out of ``session.step()`` (what a CUDA fault is: the
    scheduler retries only injected faults and OOM) is not swallowed:
    the resident stream ends at once with a ``status="error"`` done
    event carrying it, the engine thread stops, and a new request gets
    a typed ``engine-failed`` event."""
    data = _small_graph()
    srv = MatchServer(data, ServerArgs(device="cpu", port=0, n_slots=4,
                                       wave_size=64, kpr=8, limit=None,
                                       warmup_queries=0))
    monkeypatch.setattr(srv.qserver.session, "step", _device_fault)
    srv.start()
    try:
        cli = ServeClient(srv.host, srv.port, timeout=WAIT_S)
        q = query_set(data, 4, 1, seed=21)[0]
        _assert_error_stream(list(cli.stream(q, options={"limit": None})))
        assert srv._drained.wait(timeout=WAIT_S)
        assert str(srv.failure) == DEVICE_FAULT
        assert cli.metrics()["draining"] is True
        with pytest.raises(ServerError) as e:
            cli.match(q)
        assert e.value.code == "engine-failed"
    finally:
        srv.shutdown(drain=False)


def test_launch_exits_1_after_an_engine_failure(monkeypatch):
    """``python -m repro_torch.server.launch`` run in-process: a failing
    step ends the client's stream with the error and the process's
    ``main`` with 1, not with a drain's 0."""
    data = _small_graph()
    q = query_set(data, 4, 1, seed=21)[0]
    box = {}
    serve = MatchServer.serve_forever

    def serve_and_send(self):
        def send():
            cli = ServeClient(self.host, self.port, timeout=WAIT_S)
            box["events"] = list(cli.stream(q, options={"limit": None}))
        t = threading.Thread(target=send, daemon=True)
        t.start()
        serve(self)
        t.join(timeout=WAIT_S)

    monkeypatch.setattr(MatchSession, "step", _device_fault)
    monkeypatch.setattr(MatchServer, "serve_forever", serve_and_send)
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        rc = launch.main([
            "--device", "cpu", "--graph", "ba",
            "--graph-n", str(SMALL["n"]), "--graph-m", str(SMALL["m"]),
            "--graph-labels", str(SMALL["labels"]),
            "--graph-extra-edges", str(SMALL["extra"]),
            "--graph-seed", str(SMALL["seed"]), "--n-slots", "4",
            "--wave-size", "64", "--kpr", "8", "--warmup-queries", "0",
            "--quiet", "--port", "0"])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert rc == 1
    _assert_error_stream(box["events"])


# ======================================================================
# end to end: a port server subprocess over HTTP
# ======================================================================
GRAPH = dict(n=96, m=3, labels=3, extra=96, seed=3)
SERVER_ARGS = ["--device", "cpu", "--graph", "ba", "--graph-n", "96",
               "--graph-m", "3", "--graph-labels", "3",
               "--graph-extra-edges", "96", "--graph-seed", "3",
               "--n-slots", "8", "--wave-size", "64", "--kpr", "8",
               "--warmup-queries", "2", "--quiet", "--port", "0",
               "--tenants",
               json.dumps({"alpha": {"weight": 2.0},
                           "beta": {"weight": 1.0}})]


@pytest.fixture(scope="module")
def served():
    """One port server subprocess for the whole module + the identical
    graph rebuilt in-process for the oracle."""
    data = ba_labeled_graph(GRAPH["n"], GRAPH["m"], GRAPH["labels"],
                            extra_edges=GRAPH["extra"],
                            seed=GRAPH["seed"])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"      # small eager ops; tests run in parallel
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.server.launch", *SERVER_ARGS],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    info = None
    try:
        info = _wait_ready(proc)
        yield types.SimpleNamespace(
            data=data, proc=proc, info=info,
            cli=ServeClient(info["host"], info["port"], timeout=WAIT_S))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def _wait_ready(proc) -> dict:
    """The READY line, read on a thread so the wait has a deadline."""
    box = {}

    def read():
        for line in proc.stdout:
            if line.startswith("REPRO_SERVER_READY "):
                box["info"] = json.loads(line.split(" ", 1)[1])
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=WAIT_S)
    if "info" not in box:
        proc.kill()
        proc.wait()
        raise AssertionError("server never ready: "
                             + proc.stderr.read()[-2000:])
    return box["info"]


def test_e2e_ready_line(served):
    info = served.info
    assert info["device"] == "cpu" and info["n_vertices"] == GRAPH["n"]
    assert info["tenants"] == ["alpha", "beta"]
    assert info["baseline_qps"] is not None and info["baseline_qps"] > 0


def _drive(cli, queries, tenants, client_name):
    out = [None] * len(queries)
    errors = []

    def drive(i):
        try:
            tenant = tenants[i % len(tenants)]
            rows, seqs, status, first = [], [], None, None
            for ev in cli.stream(queries[i], tenant=tenant,
                                 options={"limit": None}, request_id=i):
                first = first or ev["event"]
                if ev["event"] == "chunk":
                    seqs.append(ev["seq"])
                    rows.extend(ev["rows"])
                elif ev["event"] == "done":
                    status = ev["result"]["status"]
                    assert ev["result"]["request_id"] == i
                    assert ev["result"]["tenant"] == tenant
            out[i] = (first, rows, seqs, status)
        except Exception as exc:          # reported by the main thread
            errors.append(f"{client_name} q{i}: {exc!r}")

    threads = [threading.Thread(target=drive, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a stream hung"
    assert not errors, errors
    return out


@pytest.mark.parametrize("client", ["port", "reference"])
def test_e2e_two_tenant_streams_match_oracle(served, client):
    """Six queries streamed concurrently across two tenants, by the
    port's client or the reference's: every stream opens with
    ``accepted``, chunks carry increasing ``seq``, and the chunk-row
    union is the oracle's set."""
    data = served.data
    queries = query_set(data, 4, 6, seed=21)
    if client == "port":
        cli = served.cli
        sent = queries
    else:
        cli = RefClient(served.info["host"], served.info["port"],
                        timeout=WAIT_S)
        sent = [RefGraph.from_edges(q.n, [tuple(e) for e in
                                          encode_query(q)["edges"]],
                                    q.labels.tolist(), n_labels=q.n_labels)
                for q in queries]
    want = [embset(oracle(q, data, limit=None).embeddings)
            for q in queries]
    out = _drive(cli, sent, ["alpha", "beta"], client)
    for i, (first, rows, seqs, status) in enumerate(out):
        assert first == "accepted"
        assert status == "ok"
        assert seqs == sorted(seqs)
        assert rowset(rows) == want[i], f"query {i} diverged"


def test_e2e_blocking_client_matches_oracle(served):
    data, cli = served.data, served.cli
    q = query_set(data, 4, 6, seed=21)[2]
    rows, res = cli.match(q, options={"limit": None})
    ref = oracle(q, data, limit=None)
    assert res["status"] == "ok"
    assert embset(rows) == embset(ref.embeddings)
    # the reference's blocking client, too
    rq = RefGraph.from_edges(q.n, [tuple(e) for e in
                                   encode_query(q)["edges"]],
                             q.labels.tolist(), n_labels=q.n_labels)
    rrows, rres = RefClient(served.info["host"], served.info["port"],
                            timeout=WAIT_S).match(rq,
                                                  options={"limit": None})
    assert rres["status"] == "ok" and embset(rrows) == embset(rows)


def test_e2e_bad_options_are_a_typed_error(served):
    with pytest.raises(ServerError) as e:
        served.cli.match(_tiny_query(), options={"limit": -3})
    assert e.value.code == "bad-options"


def test_e2e_disconnect_cancels_without_disturbing_residents(served):
    """Drop the connection mid-stream on a heavy query: the server
    cancels it through the eviction path (client_disconnects and
    ``cancelled`` both observable), and a query running through the
    eviction window still returns the exact oracle set."""
    data, cli = served.data, served.cli
    heavy = query_set(data, 6, 4, seed=33)[0]
    light = query_set(data, 4, 6, seed=21)[3]
    ref = oracle(light, data, limit=None)

    before = cli.metrics()["wire"].get("client_disconnects", 0)
    it = cli.stream(heavy, tenant="alpha", options={"limit": None})
    for ev in it:
        if ev["event"] == "chunk" and ev["rows"]:
            break
        assert ev["event"] != "done", "heavy query finished too fast"
    it.close()

    rows, res = cli.match(light, tenant="beta", options={"limit": None})
    assert res["status"] == "ok"
    assert embset(rows) == embset(ref.embeddings)

    deadline = time.monotonic() + 60
    while True:
        m = cli.metrics()
        slo = cli.slo()
        if (m["wire"].get("client_disconnects", 0) > before
                and slo.get("cancelled", 0) >= 1):
            break
        assert time.monotonic() < deadline, (
            f"no cancellation observed: wire={m['wire']} slo={slo}")
        time.sleep(0.2)


def test_e2e_slo_and_metrics_shape(served):
    cli = served.cli
    health = cli.health()
    assert health["ok"] is True and health["graph"]["n_vertices"] == 96
    slo = cli.slo()
    for k in ("queue_depth", "resident_queries",
              "backpressure_absorbed"):
        assert isinstance(slo[k], int) and slo[k] >= 0
    assert slo["tuning"]["source"] == "builtin"
    assert slo["tuning"]["backend"] == "torch"
    m = cli.metrics()
    assert set(m["tenants"]) >= {"alpha", "beta"}
    for t in m["tenants"].values():
        assert t["offered"] >= t["admitted"] >= 0
    # on the CPU the refines run their plain versions: no launch
    assert m["kernel_launches"] == {"refine_bitmap_rows": 0,
                                    "refine_bitmap_rows_hier": 0}


def test_e2e_sigterm_drains_and_exits_0(served):
    """Last in the module: SIGTERM while a heavy query is resident. A
    new request is refused with a typed ``draining`` event, the
    resident query finishes ``ok`` with the oracle's set, the final SLO
    report is flushed, and the process exits 0."""
    data, cli, proc = served.data, served.cli, served.proc
    heavy = query_set(data, 6, 4, seed=33)[0]
    want = embset(oracle(heavy, data, limit=None).embeddings)
    box = {"rows": []}
    streaming = threading.Event()

    def run_heavy():
        try:
            for ev in cli.stream(heavy, options={"limit": None}):
                if ev["event"] == "chunk":
                    box["rows"].extend(ev["rows"])
                    streaming.set()
                elif ev["event"] == "done":
                    box["result"] = ev["result"]
        except Exception as exc:      # reported by the main thread
            box["err"] = repr(exc)
        finally:
            streaming.set()

    t = threading.Thread(target=run_heavy)
    t.start()
    assert streaming.wait(timeout=WAIT_S), "heavy query never streamed"
    assert "result" not in box, "heavy query finished too fast"
    proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + WAIT_S
    while not cli.metrics()["draining"]:
        assert time.monotonic() < deadline, "no drain"
        time.sleep(0.05)
    with pytest.raises(ServerError) as e:
        cli.match(_tiny_query())
    assert e.value.code == "draining"
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and "err" not in box, box.get("err")
    assert box["result"]["status"] == "ok"
    assert rowset(box["rows"]) == want
    assert proc.wait(timeout=WAIT_S) == 0
    assert "REPRO_SERVER_SLO " in proc.stderr.read()
