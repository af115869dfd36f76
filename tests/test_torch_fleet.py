"""Multi-replica serving on the port: the router, the in-process fleet and
the HTTP router tier.

  * The port's PrefixAffinityRouter makes JAX's decisions (replica,
    reason, estimated hit, candidates), keeps the same index LRU and
    stats for the same update / route sequence, with and without
    affinity, over phases; prefix_digests and the trie's digests() equal
    JAX's for the same prompts and operations.
  * Fleet (tiny fp32 model, seeded init with its matrices x 8, on the
    CPU): the colocated engine's tokens whichever replica serves;
    same-prefix followers land on the warm replica; drained and
    quarantined replicas leave the rotation; a replica_down kill at
    several steps fails its requests over, each ending once with the
    same tokens; an out-of-vocab prompt is rejected and poisons nothing;
    the retry hint is the minimum over ready replicas; rids are
    namespaced and the ledgers merge; priority and SLO fields pass
    through.
  * HTTP on loopback: a prefill and a decode server behind a
    RouterFrontend migrate a /generate (the colocated engine's tokens,
    the migration counters on both pods), and a frontend whose replicas
    are all down answers 503.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from nanosandbox_tpu.serve.paged import BlockPool as JaxBlockPool
from nanosandbox_tpu.serve.paged import prefix_digests as jax_digests
from nanosandbox_tpu.serve.router import \
    PrefixAffinityRouter as JaxRouter
from nanosandbox_tpu_torch.checkpoint import save_for_serving
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.obs.flight import TERMINAL_EVENTS
from nanosandbox_tpu_torch.serve.__main__ import build_server
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.faults import FaultPlan
from nanosandbox_tpu_torch.serve.fleet import Fleet
from nanosandbox_tpu_torch.serve.http import RouterFrontend
from nanosandbox_tpu_torch.serve.paged import BlockPool, prefix_digests
from nanosandbox_tpu_torch.serve.router import (NoReadyReplicaError,
                                                PrefixAffinityRouter)

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
KW = dict(num_slots=4, max_len=64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    m = GPT(GPTConfig(**DIMS, compute_dtype="float32"),
            generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 2:
                p.mul_(8)
    return m


# ---------------------------------------------------------------------------
# the router and the digests, against JAX's
# ---------------------------------------------------------------------------

def _router_script(cls, affinity, rng):
    """A seeded sequence of updates, digest reports, summary refreshes and
    routes (some with exclusions, failover, phases) over four replicas,
    two with tier roles; the decisions and final stats."""
    names = ["a", "b", "c", "d"]
    r = cls(names, page=4, index_cap=6, affinity=affinity, seed=3,
            roles={"c": "prefill", "d": "decode"})
    chains = [jax_digests(rng.integers(0, 5, 20).tolist(), 4)
              for _ in range(6)]
    out = []
    for i in range(80):
        op = int(rng.integers(0, 6))
        name = names[int(rng.integers(0, 4))]
        chain = chains[int(rng.integers(0, len(chains)))]
        if op == 0:
            r.update_replica(name, ready=bool(rng.integers(0, 5)),
                             reason="x", queued=int(rng.integers(0, 4)),
                             active=int(rng.integers(0, 4)),
                             brownout=int(rng.integers(0, 2)))
        elif op == 1:
            r.observe_digests(name, chain[:int(rng.integers(1, 6))])
        elif op == 2 and i % 7 == 0:
            r.refresh_summary(name, chain[:int(rng.integers(0, 4))])
        elif op == 3 and i % 11 == 0:
            r.forget(name)
        else:
            phase = [None, "prefill", "decode"][int(rng.integers(0, 3))]
            excl = (name,) if rng.integers(0, 4) == 0 else ()
            try:
                d = r.route(chain, exclude=excl,
                            failover=bool(rng.integers(0, 6) == 0),
                            phase=phase)
                out.append((d.replica, d.reason, d.est_hit_tokens,
                            d.candidates))
            except Exception as e:          # NoReadyReplicaError
                out.append(("raise", type(e).__name__, str(e)))
        out.append({n: list(v.index._set) for n, v in r.replicas.items()})
    st = r.stats()
    for v in st["replicas"].values():
        v.pop("age_s")
    return out, st


@pytest.mark.parametrize("affinity", [True, False])
def test_router_decisions_and_index_match_jax(affinity):
    ours = _router_script(PrefixAffinityRouter, affinity,
                          np.random.default_rng(1))
    theirs = _router_script(JaxRouter, affinity, np.random.default_rng(1))
    assert ours == theirs
    reasons = Counter(d[1] for d in ours[0] if isinstance(d, tuple))
    assert reasons["raise"] + sum(reasons.values()) > 0
    if affinity:
        assert reasons["affinity"] and reasons["load"] and \
            reasons["fallback"]


def test_prefix_digests_and_trie_digests_match_jax():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 50, 64).tolist()
    prompts = [base[:n] + rng.integers(0, 50, k).tolist()
               for n, k in ((0, 40), (16, 9), (32, 33), (48, 2), (64, 0))]
    for p in prompts:
        for page in (4, 16):
            assert prefix_digests(p, page) == jax_digests(p, page)
    ours, theirs = BlockPool(40, 8), JaxBlockPool(40, 8)
    for pool in (ours, theirs):
        for p in prompts:
            a = pool.admit(p, 3)
            pool.release(a)
    assert ours.cache.digests() == theirs.cache.digests()
    assert set(prefix_digests(prompts[2], 8)) <= set(ours.cache.digests())


# ---------------------------------------------------------------------------
# the in-process fleet
# ---------------------------------------------------------------------------

def _requests(n=8, seed=0, shared=32):
    """Requests sharing a ``shared``-token prefix (greedy and sampled)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 65, shared).tolist()
    out = []
    for i in range(n):
        kw = {"seed": i}
        if i % 2:
            kw.update(temperature=0.8, top_k=5)
        out.append((head + rng.integers(0, 65, int(rng.integers(2, 12)))
                    .tolist(), int(rng.integers(3, 12)), kw))
    return out


def _colocated(model, reqs):
    eng = Engine(model, **KW)
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    got = {r.rid: (r.tokens, r.finish_reason) for r in eng.drain()}
    return [got[r] for r in rids]


def _drive(fleet, reqs):
    rids = [fleet.submit(p, n, **kw) for p, n, kw in reqs]
    out = fleet.drain()
    assert sorted(r.rid for r in out) == sorted(rids)    # each ends once
    got = {r.rid: (r.tokens, r.finish_reason) for r in out}
    return rids, [got[r] for r in rids]


def test_fleet_parity_and_affinity(model):
    reqs = _requests()
    want = _colocated(model, reqs)
    fleet = Fleet(model, n_replicas=2, **KW)
    rids, got = _drive(fleet, reqs)
    assert got == want
    # Followers of the shared prefix route to its warm replica (until its
    # queue outweighs the hit: 8 x load against 32 hit tokens).
    assert fleet.router.decisions["affinity"] >= 6
    homes = [rid.split(":")[0] for rid in rids]
    assert homes[1:4] == [homes[0]] * 3
    # A second burst of unrelated prompts spreads by load; tokens still
    # the colocated engine's whichever replica serves.
    reqs2 = _requests(seed=1, shared=0)
    rids2, got2 = _drive(fleet, reqs2)
    assert got2 == _colocated(model, reqs2)
    assert len({rid.split(":")[0] for rid in rids2}) == 2
    st = fleet.stats()
    assert st["completed"] == st["submitted"] == 16
    assert st["in_flight"] == 0 and st["failovers"] == 0


def test_drain_and_quarantine_leave_the_rotation(model):
    fleet = Fleet(model, n_replicas=2, **KW)
    fleet.drain_replica("r0")
    assert [fleet.submit([1, 2, 3], 2).split(":")[0]
            for _ in range(3)] == ["r1"] * 3
    assert fleet.stats()["replicas"]["r0"]["reason"] == "draining"
    fleet.undrain_replica("r0")
    fleet.drain()
    fleet.replicas["r1"].quarantine("test")
    assert [fleet.submit([4, 5], 2).split(":")[0]
            for _ in range(3)] == ["r0"] * 3
    fleet.drain_replica("r0")
    with pytest.raises(NoReadyReplicaError):
        fleet.submit([6], 2)
    assert fleet.retry_info()["replica_set"] == 0


@pytest.mark.parametrize("kill_step", [0, 2, 5, 9])
def test_replica_down_failover_exactly_once(model, kill_step):
    reqs = _requests(seed=3, shared=8)
    want = _colocated(model, reqs)
    fleet = Fleet(model, n_replicas=2,
                  faults=FaultPlan.parse(f"replica_down@{kill_step}"), **KW)
    rids, got = _drive(fleet, reqs)
    assert got == want
    assert fleet.replica_downs == 1 and fleet.failovers >= 1
    dead = [n for n, e in fleet.replicas.items() if e.failed]
    assert len(dead) == 1
    assert fleet.router.stats()["replicas"][dead[0]]["ready"] is False
    events = fleet.merged_flight_events()
    terms = Counter(e["rid"] for e in events if e["ev"] in TERMINAL_EVENTS)
    assert max(terms.values()) == 1
    fails = [e for e in events if e["ev"] == "failover"]
    assert len(fails) == fleet.failovers
    assert all(e["dead"] == dead[0] and e["replica"] != dead[0]
               for e in fails)
    assert not any(e["ev"] in TERMINAL_EVENTS for e in fleet.flight.events())


def test_out_of_vocab_prompt_is_rejected_and_poisons_nothing(model):
    fleet = Fleet(model, n_replicas=2, **KW)
    with pytest.raises(ValueError, match="outside"):
        fleet.submit([1, 2, DIMS["vocab_size"]], 4)
    assert fleet.stats()["in_flight"] == 0
    assert fleet.router.ready_replicas() == ["r0", "r1"]
    reqs = _requests(n=3, seed=4)
    assert _drive(fleet, reqs)[1] == _colocated(model, reqs)


def test_retry_after_is_the_minimum_over_ready_replicas(model):
    fleet = Fleet(model, n_replicas=3, **KW)
    hints = {"r0": 4.0, "r1": 2.5, "r2": 7.0}
    for name, eng in fleet.replicas.items():
        eng.retry_after_s = (lambda slo_class=None, _h=hints[name]: _h)
    assert fleet.retry_after_s() == 2.5
    fleet.drain_replica("r1")
    assert fleet.retry_info() == {"retry_after_s": 4.0, "replica_set": 2}
    fleet.drain_replica("r0")
    fleet.drain_replica("r2")
    assert fleet.retry_after_s() == 1.0


def test_flight_namespacing_and_merge(model):
    fleet = Fleet(model, n_replicas=2, **KW)
    rids, _ = _drive(fleet, _requests(n=4, seed=5, shared=0))
    events = [json.loads(line)
              for line in fleet.merged_flight_jsonl().splitlines()]
    assert [e["wall"] for e in events] == sorted(e["wall"] for e in events)
    routes = {e["rid"]: e for e in events if e["ev"] == "route"}
    assert sorted(routes) == sorted(rids)
    for rid in rids:
        mine = [e["ev"] for e in events if e.get("rid") == rid]
        assert mine[0] in ("submit", "route") and "finish" in mine
        assert sum(ev in TERMINAL_EVENTS for ev in mine) == 1
    assert all(":" in str(e["rid"]) for e in events if "rid" in e
               and e["rid"] is not None)


def test_priority_and_slo_fields_pass_through(model):
    fleet = Fleet(model, n_replicas=2, **KW)
    rid = fleet.submit([1, 2, 3, 4], 3, slo_class="interactive",
                       priority=5, deadline_s=120.0)
    name, local = rid.split(":")
    (ev,) = [e for e in fleet.replicas[name].flight.events(rid=int(local))
             if e["ev"] == "submit"]
    assert (ev["slo_class"], ev["priority"], ev["deadline_s"]) == (
        "interactive", 5, 120.0)
    (res,) = fleet.drain()
    assert res.rid == rid and res.finish_reason == "length"


def test_tensor_parallel_replicas_raise(model):
    """Tensor-parallel replicas are ported: Fleet(tp=2) builds tp 2
    engines (every shard on the replicas' one device) and drains with
    the tokens of a tp 1 fleet."""
    prompts = [[1, 2, 3, 4], [5, 6, 7], [1, 2, 3, 9, 9]]
    out = {}
    for tp in (1, 2):
        fleet = Fleet(model, n_replicas=2, tp=tp, **KW)
        assert all(e.tp == tp for e in fleet.replicas.values())
        rids = [fleet.submit(p, 4) for p in prompts]
        got = {r.rid: r.tokens for r in fleet.drain()}
        out[tp] = [got[r] for r in rids]
    assert out[2] == out[1] and all(len(t) == 4 for t in out[2])


# ---------------------------------------------------------------------------
# the HTTP tiers on loopback
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _metric(text, name):
    return sum(float(line.split()[-1]) for line in text.splitlines()
               if line.startswith(name + " ") or line.startswith(name + "{"))


def test_http_router_migrates_between_tiers(model, tmp_path):
    save_for_serving(str(tmp_path), model.cfg, model.state_dict())
    servers = {}
    for role in ("prefill", "decode"):
        server, loop, _ = build_server([
            f"--out_dir={tmp_path}", "--host=127.0.0.1", "--port=0",
            "--num_slots=4", "--max_len=64", "--device=cpu",
            "--warmup=buckets", "--no_watchdogs", f"--role={role}"])
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers[role] = (server, loop,
                         f"http://127.0.0.1:{server.server_address[1]}")
    fe = RouterFrontend([servers[r][2] for r in ("prefill", "decode")],
                        host="127.0.0.1", port=0, health_interval_s=0.1,
                        page=16).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        deadline = time.monotonic() + 30
        while not fe._phase_tiering():
            assert time.monotonic() < deadline, fe.router.stats()
            time.sleep(0.05)
        prompt, kw = list(range(5, 45)), dict(temperature=0.8, top_k=5,
                                              seed=3)
        ((tokens, reason),) = _colocated(model, [(prompt, 9, kw)])
        status, body = _post(base + "/generate", dict(
            prompt_tokens=prompt, max_new_tokens=9, **kw))
        assert status == 200, body
        assert body["tokens"] == tokens and body["finish_reason"] == reason
        assert body["migrated_from"] == servers["prefill"][2]
        assert body["replica"] == servers["decode"][2]
        _, m = _get(servers["prefill"][2] + "/metrics")
        assert _metric(m, "serve_migrated_out_total") >= 1
        assert _metric(m, 'serve_engine_role{role="prefill"}') == 1
        _, m = _get(servers["decode"][2] + "/metrics")
        assert _metric(m, "serve_adopted_in_total") >= 1
        _, dec = _get(servers["decode"][2] + "/stats")
        assert json.loads(dec)["prefill_waves"] == 0
        _, summary = _get(servers["prefill"][2] + "/debug/prefix_summary")
        assert set(prefix_digests(prompt, 16)) <= set(
            json.loads(summary)["digests"])
        _, router = _get(base + "/debug/router")
        assert json.loads(router)["router"]["replicas"][
            servers["decode"][2]]["role"] == "decode"
        _, m = _get(base + "/metrics")
        assert _metric(m, 'serve_migrations_total{outcome="ok"}') == 1
    finally:
        fe.stop()
        for server, loop, _ in servers.values():
            server.shutdown()
            server.server_close()
            loop.stop()


def test_http_export_done_fallback_and_timeout_reclaim(model, tmp_path):
    """A prefill replica alone: a migrate-flagged /generate answers 202
    with its export; export_done ok=false requeues it colocated and
    answers with the colocated engine's tokens; an export whose callback
    never comes is reclaimed after export_timeout_s (its export_done then
    410), and /internal/adopt answers 400 to a payload that is none."""
    save_for_serving(str(tmp_path), model.cfg, model.state_dict())
    server, loop, _ = build_server([
        f"--out_dir={tmp_path}", "--host=127.0.0.1", "--port=0",
        "--num_slots=4", "--max_len=64", "--device=cpu", "--warmup=buckets",
        "--no_watchdogs", "--role=prefill"])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        prompt = list(range(9, 40))
        ((tokens, reason),) = _colocated(model, [(prompt, 7, {})])
        body = dict(prompt_tokens=prompt, max_new_tokens=7,
                    temperature=0.0, migrate=True)
        status, exp = _post(base + "/generate", body)
        assert status == 202 and exp["migrate"] is True
        assert exp["export"]["first_tok"] == tokens[0]
        status, out = _post(base + "/internal/export_done",
                            {"rid": exp["id"], "ok": False})
        assert status == 200 and out["migrate_fallback"] is True
        assert (out["tokens"], out["finish_reason"]) == (tokens, reason)
        loop.export_timeout_s = 0.2
        status, exp = _post(base + "/generate", body)
        assert status == 202
        deadline = time.monotonic() + 30
        while loop.call(lambda eng: exp["id"] in loop._exports):
            assert time.monotonic() < deadline
            time.sleep(0.1)
        status, _ = _post(base + "/internal/export_done",
                          {"rid": exp["id"], "ok": True})
        assert status == 410
        status, _ = _post(base + "/internal/adopt", {"prompt": [1]})
        assert status == 400
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()


def test_http_router_answers_503_when_every_replica_is_down():
    fe = RouterFrontend(["http://127.0.0.1:1"], host="127.0.0.1", port=0,
                        health_interval_s=0.1).start()
    base = f"http://127.0.0.1:{fe.port}"
    try:
        deadline = time.monotonic() + 10
        while fe.router.stats()["replicas"]["http://127.0.0.1:1"][
                "age_s"] is None:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        status, body = _post(base + "/generate", {"prompt_tokens": [1, 2],
                                                  "max_new_tokens": 2})
        assert status == 503 and body["replica_set"] == 0
        try:
            _get(base + "/healthz")
            raise AssertionError("healthz should be 503")
        except urllib.error.HTTPError as e:
            assert e.code == 503
    finally:
        fe.stop()
