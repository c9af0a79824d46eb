"""The port's multihost serving (``serving/multihost/``) against the JAX
package's router, workers and greedy oracle.

The tiny GPT-2 of ``tests/test_multihost.py`` (vocab 97, 48 positions,
2 x 48, 4 heads, fp32) is initialised by flax from seed 0 and carried into
the port through ``gpt2_state_dict_from_flax``. Every stream the port's
``Router`` returns must equal the JAX uncached-forward argmax oracle
(``tests.test_multihost.greedy_oracle``) token for token, across an
eviction's refeed and a live weight push too, and where the JAX ``Router``
and ``HostWorker`` run the same co-stepped scenario, the port's routes,
refeeds and admission traces must be the JAX ones. The control-plane
invariants are the reference tests': exactly-once finishes, backpressure,
page headroom, the fenced channel of a rejoin, a rejected prompt, a
duplicate id, the accept rate summed over hosts, and an EOS stream cut at
its FIRST EOS (the reference's ``test_eos_request_roundtrip`` expects four
copies of a token that the oracle emits from the start; the router is
right to stop at the first). Protocol messages are byte for byte the JAX
module's. One case SIGKILLs a worker process on a ``TCPStore``
(``tests/_torch_port_mh_worker.py``).

Most cases step router and workers in one thread: the control plane polls,
so that is legal and deterministic. No assertion reads a wall-clock rate.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.distributed.store import HashStore, TCPStore
from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributed_tpu_torch.observability import recent_events
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    Request,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serving.multihost import (
    HostWorker,
    Keys,
    Router,
    protocol,
)

torch.set_num_threads(2)

REPO = Path(__file__).parent.parent
TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def tiny():
    """The JAX model and variables, and the same weights as the port's
    state dict."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    model = JaxGPT2(JaxCfg(dtype=jnp.float32, **TINY))
    variables = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    sd = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return model, variables, sd


def port_model(sd):
    model = GPT2(GPT2Config(**TINY), device="cpu")
    model.load_state_dict(sd)
    return model


def port_scheduler(tiny, *, n_slots=2, prefill_len=32, step_delay_s=0.0,
                   **engine_kw):
    engine = InferenceEngine(port_model(tiny[2]), n_slots=n_slots,
                             max_len=48, prefill_len=prefill_len,
                             device="cpu", **engine_kw)
    sched = Scheduler(engine, emit_events=False)
    if step_delay_s:
        real_step = sched.step

        def slow_step():
            time.sleep(step_delay_s)
            return real_step()

        sched.step = slow_step
    return sched


def make_worker(store, tiny, host_id, *, param_loader=None, **kw):
    return HostWorker(store, port_scheduler(tiny, **kw), host_id=host_id,
                      param_loader=param_loader)


def jax_worker(store, tiny, host_id, *, n_slots=2, prefill_len=32,
               param_loader=None, **engine_kw):
    from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
    from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
    from pytorch_distributed_tpu.serving.multihost import (
        HostWorker as JaxWorker,
    )

    model, variables, _ = tiny
    engine = JaxEngine(model, variables, n_slots=n_slots, max_len=48,
                       prefill_len=prefill_len, **engine_kw)
    return JaxWorker(store, JaxScheduler(engine, emit_events=False),
                     host_id=host_id, param_loader=param_loader)


def oracle(tiny, prompt, n):
    from tests.test_multihost import greedy_oracle

    return greedy_oracle(tiny[0], tiny[1], prompt, n)


def prompts_and_oracles(tiny, n, *, max_new=10, rng_seed=0):
    """``tests/test_multihost.py``'s prompts: the prompt arrays (each side
    wraps them in its own ``Request``) and their oracle streams."""
    rng = np.random.default_rng(rng_seed)
    prompts, oracles = [], {}
    for i in range(n):
        prompt = rng.integers(0, 97, size=int(rng.integers(3, 7)))
        prompts.append(prompt)
        oracles[i] = oracle(tiny, prompt, max_new)
    return prompts, oracles


def events_since(mark, name):
    return [e for e in recent_events(10_000)[mark:] if e.name == name]


def event_mark():
    return len(recent_events(10_000))


def co_step(router, workers, finished, *, until=None, timeout=60.0,
            sleep=0.0):
    """Step every worker then the router until nothing is pending or in
    flight (or ``until()``)."""
    deadline = time.monotonic() + timeout
    while router._pending or router._inflight:
        if until is not None and until():
            return
        assert time.monotonic() < deadline, "the router did not drain"
        for w in workers:
            w.step()
        finished.extend(router.step())
        if sleep:
            time.sleep(sleep)


def streams(finished):
    return {f.request_id: list(f.tokens) for f in finished}


# -- the wire format -----------------------------------------------------------
MESSAGES = {
    "announce": ("announce_msg", ("host0", 3), dict(
        n_slots=8, prefill_len=128, max_len=1024, spec_k=3, page_size=16)),
    "wire_request": ("wire_request", (5, 9, [1, 2, 3], 64, None), {}),
    "wire_request_eos": ("wire_request", (5, 9, [1, 2, 3], 64, 50256), {}),
    "tokens": ("tokens_chunk", (5, 9, 2, [7, 7, 8]), {}),
    "finished": ("finished_msg", (5, 9, 4), dict(
        reason="eos", n_tokens=17, ttft_s=0.0125, total_s=0.25)),
    "load": ("load_msg", (), dict(
        hb=12, active=3, queued=1, n_slots=8, draining=False,
        accept_num=14.0, accept_den=24.0, weights_version=2,
        free_pages=37)),
    "load_defaults": ("load_msg", (), dict(
        hb=0, active=0, queued=0, n_slots=2, draining=True)),
    "weights": ("weights_msg", (1, "/ckpts/run", 7), {}),
    "weights_latest": ("weights_msg", (2, "/ckpts/run", None), {}),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_protocol_bytes_equal_the_references(name):
    from pytorch_distributed_tpu.serving.multihost import protocol as ref

    fn, args, kw = MESSAGES[name]
    got = protocol.dumps(getattr(protocol, fn)(*args, **kw))
    assert got == ref.dumps(getattr(ref, fn)(*args, **kw))
    assert protocol.loads(got) == ref.loads(got)


def test_protocol_keys_equal_the_references():
    from pytorch_distributed_tpu.serving.multihost import Keys as RefKeys
    from pytorch_distributed_tpu.serving.multihost import protocol as ref

    assert protocol.DEFAULT_NAMESPACE == ref.DEFAULT_NAMESPACE
    for ns in (protocol.DEFAULT_NAMESPACE, "fleet-a"):
        k, r = Keys(ns), RefKeys(ns)
        assert k.members() == r.members()
        for chan in (0, 7):
            for fn in ("in_seq", "load", "stop", "weights"):
                assert getattr(k, fn)(chan) == getattr(r, fn)(chan)
            assert k.member(chan) == r.member(chan)
            assert k.inbox(chan, 3) == r.inbox(chan, 3)
            assert k.outbox(chan, 3) == r.outbox(chan, 3)


# -- the scheduler's admission capacity ----------------------------------------
@pytest.mark.parametrize("cache_kind", ["slotted", "paged"])
def test_free_pages_matches_jax(tiny, cache_kind):
    """``Scheduler.free_pages`` against the JAX property at every
    occupancy of a run: empty, filling, draining, empty again."""
    from pytorch_distributed_tpu.serving import Request as JaxRequest

    kw = dict(n_slots=3, prefill_len=16)
    if cache_kind == "paged":
        kw.update(cache_kind="paged", page_size=4, n_pages=20)
    port = port_scheduler(tiny, **kw)
    ref = jax_worker(HashStore(), tiny, "ref", **kw).scheduler
    rng = np.random.default_rng(7)
    got, want = [port.free_pages], [ref.free_pages]
    for i in range(5):
        prompt = rng.integers(0, 97, size=int(rng.integers(3, 12)))
        port.submit(Request(prompt=prompt, max_new_tokens=3 + 2 * i))
        ref.submit(JaxRequest(prompt=prompt, max_new_tokens=3 + 2 * i))
        port.step()
        ref.step()
        got.append(port.free_pages)
        want.append(ref.free_pages)
    while port.has_work or ref.has_work:
        port.step()
        ref.step()
        got.append(port.free_pages)
        want.append(ref.free_pages)
    assert got == want
    assert len(set(got)) > 2               # several occupancies seen
    assert isinstance(got[0], int)
    if cache_kind == "slotted":
        assert got[0] == 3 * port.engine.max_pages
    assert port.stats()["free_pages" if cache_kind == "paged"
                        else "decode_steps"] >= 0


# -- two live workers in threads, graceful drain --------------------------------
def test_two_host_smoke_greedy_parity(tiny):
    store = HashStore()
    workers = [make_worker(store, tiny, f"host{i}") for i in range(2)]
    threads = [threading.Thread(target=w.serve_forever, daemon=True)
               for w in workers]
    mark = event_mark()
    for t in threads:
        t.start()
    router = Router(store, heartbeat_ttl_s=30.0)
    prompts, oracles = prompts_and_oracles(tiny, 6, max_new=8)
    ids = [router.submit(Request(prompt=p, max_new_tokens=8))
           for p in prompts]
    assert ids == list(range(6))
    finished = router.run(timeout_s=120)
    router.stop_hosts()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(f.request_id for f in finished) == ids   # exactly once
    for f in finished:
        assert f.tokens == oracles[f.request_id], f.request_id
        assert f.reason == "length"
    per_host = router.stats()["per_host_routed"]
    assert set(per_host) == {"host0", "host1"}
    assert all(v > 0 for v in per_host.values())
    routes = events_since(mark, "serving.route")
    assert sorted(e.metadata["request_id"] for e in routes) == ids
    assert events_since(mark, "serving.host_evict") == []
    joins = events_since(mark, "serving.host_join")
    assert {e.metadata["host"] for e in joins
            if e.source == "router"} == {"host0", "host1"}
    for w in workers:
        load = protocol.loads(store.get_nowait(w.keys.load(w.chan)))
        assert load["draining"] and load["active"] == 0


# -- a forced eviction mid-decode: the refeed --------------------------------------
def _evict_scenario(tiny, make, router_cls, request_cls, events):
    """Two hosts, four requests routed 2 + 2, three co-steps, host0
    killed: the survivor finishes everything. Returns the streams, the
    committed prefixes at the kill, and the event trace."""
    store = HashStore()
    w0, w1 = make(store, tiny, "host0"), make(store, tiny, "host1")
    w0.register()
    w1.register()
    router = router_cls(store, heartbeat_ttl_s=0.4)
    prompts, _ = prompts_and_oracles(tiny, 4, max_new=12, rng_seed=1)
    ids = [router.submit(request_cls(prompt=p, max_new_tokens=12))
           for p in prompts]
    mark = len(events(10_000))
    finished = list(router.step())         # discovers hosts, routes 2 + 2
    victims = [rid for rid, inf in router._inflight.items()
               if inf.chan == w0.chan]
    for _ in range(3):
        w0.step()
        w1.step()
        finished.extend(router.step())
    committed = {rid: list(router._inflight[rid].committed)
                 for rid in victims if rid in router._inflight}
    w0.kill()
    co_step(router, [w1], finished, sleep=0.01)
    trace = [(e.name, dict(e.metadata)) for e in events(10_000)[mark:]
             if e.name in ("serving.host_evict", "serving.rebalance",
                           "serving.route") and e.source == "router"]
    return ids, victims, finished, committed, trace, router


def test_eviction_mid_decode_refeed_matches_oracle_and_jax(tiny):
    from pytorch_distributed_tpu.observability import (
        recent_events as jax_events,
    )
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving.multihost import Router as JaxRouter

    _, oracles = prompts_and_oracles(tiny, 4, max_new=12, rng_seed=1)
    ids, victims, finished, committed, trace, router = _evict_scenario(
        tiny, make_worker, Router, Request, recent_events)
    assert len(victims) == 2       # least-loaded alternation split the load
    assert any(len(v) > 0 for v in committed.values())
    assert any(len(v) < 12 for v in committed.values())
    assert sorted(f.request_id for f in finished) == ids   # exactly once
    for f in finished:
        assert f.tokens == oracles[f.request_id], (
            f"request {f.request_id}: refeed stream diverged from oracle")
    evicts = [m for n, m in trace if n == "serving.host_evict"]
    assert len(evicts) == 1 and evicts[0]["host"] == "host0"
    rebalances = [m for n, m in trace if n == "serving.rebalance"]
    assert {m["request_id"] for m in rebalances} == set(committed)
    for m in rebalances:
        assert m["committed"] == len(committed[m["request_id"]])
    routes = [m for n, m in trace if n == "serving.route"]
    assert len(routes) == len(ids) + len(rebalances)
    refeeds = [m for m in routes if m["refeed"]]
    assert {m["request_id"] for m in refeeds} == set(committed)
    assert {m["host"] for m in refeeds} == {"host1"}
    assert router.stats()["rebalances"] == len(rebalances)

    # the JAX router and workers through the same scenario
    j_ids, j_victims, j_fin, j_committed, j_trace, _ = _evict_scenario(
        tiny, jax_worker, JaxRouter, JaxRequest, jax_events)
    assert (j_ids, j_victims, j_committed) == (ids, victims, committed)
    assert streams(j_fin) == streams(finished)

    def strip(tr):     # route ids and lengths, not timings
        return [(n, {k: v for k, v in m.items() if k != "in_flight"})
                for n, m in tr]

    assert strip(j_trace) == strip(trace)


def test_rejoin_after_eviction_gets_fresh_channel(tiny):
    """A recovered host rejoins by registering again: a new channel, no
    replay of the dead channel's inbox, and it takes the traffic."""
    store = HashStore()
    w0 = make_worker(store, tiny, "host0")
    w0.register()
    router = Router(store, heartbeat_ttl_s=0.3)
    prompts, oracles = prompts_and_oracles(tiny, 2, max_new=6, rng_seed=2)
    ids = [router.submit(Request(prompt=p, max_new_tokens=6))
           for p in prompts]
    finished = router.step()               # routed to host0
    w0.kill()                              # dies before committing a token
    time.sleep(0.35)
    finished.extend(router.step())         # evicted; requests back pending
    assert router.stats()["evictions"] == 1
    assert all(not hv.alive for hv in router.hosts.values())
    w0b = make_worker(store, tiny, "host0")
    w0b.register()
    assert w0b.chan != w0.chan
    co_step(router, [w0b], finished)
    assert sorted(f.request_id for f in finished) == ids
    for f in finished:
        assert f.tokens == oracles[f.request_id]
    assert w0b._in_cursor == len(ids)      # the dead inbox never replayed
    assert router.stats()["per_host_routed"] == {"host0": 2}


# -- admission control ------------------------------------------------------------
def test_backpressure_caps_outstanding_per_host(tiny):
    store = HashStore()
    w = make_worker(store, tiny, "host0", n_slots=1)
    w.register()
    router = Router(store, heartbeat_ttl_s=30.0, queue_depth=1)
    prompts, oracles = prompts_and_oracles(tiny, 5, max_new=5, rng_seed=3)
    ids = [router.submit(Request(prompt=p, max_new_tokens=5))
           for p in prompts]
    finished, max_out = [], 0
    deadline = time.monotonic() + 120
    while (router._pending or router._inflight) and time.monotonic() < deadline:
        finished.extend(router.step())
        hv = next(iter(router.hosts.values()))
        max_out = max(max_out, len(hv.outstanding))
        w.step()
    assert sorted(f.request_id for f in finished) == ids
    assert max_out <= 2   # n_slots + queue_depth: the rest were held back
    for f in finished:
        assert f.tokens == oracles[f.request_id]


def _paged_headroom_run(tiny, make, router_cls, request_cls):
    """Two paged hosts with 8 allocatable pages of 4 positions: a request's
    worst case is 4 pages, so a host takes two at a time whatever its
    slots and queue depth allow. Returns the streams and, per router step,
    each host's outstanding count and published free pages."""
    kw = dict(n_slots=3, cache_kind="paged", page_size=4, n_pages=9)
    store = HashStore()
    workers = [make(store, tiny, f"host{i}", **kw) for i in range(2)]
    for w in workers:
        w.register()
    router = router_cls(store, heartbeat_ttl_s=30.0, queue_depth=2)
    prompts, _ = prompts_and_oracles(tiny, 8, max_new=10, rng_seed=8)
    for p in prompts:
        router.submit(request_cls(prompt=p, max_new_tokens=10))
    finished, trace = [], []
    deadline = time.monotonic() + 120
    while router._pending or router._inflight:
        assert time.monotonic() < deadline
        finished.extend(router.step())
        trace.append(tuple(
            (len(hv.outstanding), hv.load.get("free_pages"))
            for hv in sorted(router.hosts.values(), key=lambda h: h.chan)))
        for w in workers:
            w.step()
    return streams(finished), trace, router.stats()


def test_page_headroom_on_paged_hosts(tiny):
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving.multihost import Router as JaxRouter

    _, oracles = prompts_and_oracles(tiny, 8, max_new=10, rng_seed=8)
    got, trace, stats = _paged_headroom_run(tiny, make_worker, Router,
                                            Request)
    assert got == oracles
    assert max(n for step in trace for n, _ in step) == 2   # pages, not slots
    assert any(fp == 0 for step in trace for _, fp in step)  # pool used up
    assert all(n > 0 for n in stats["per_host_routed"].values())
    want, j_trace, j_stats = _paged_headroom_run(tiny, jax_worker, JaxRouter,
                                                 JaxRequest)
    assert want == got
    assert j_trace == trace
    for key in ("free_pages", "per_host_routed", "routed"):
        assert j_stats[key] == stats[key], key


def test_router_rejects_unroutable_prompt(tiny):
    store = HashStore()
    w = make_worker(store, tiny, "host0", prefill_len=8)
    w.register()
    router = Router(store)
    router.submit(Request(prompt=np.arange(9), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="prefill window"):
        router.step()


def test_worker_rejects_oversized_inbox_entry(tiny):
    """A misconfigured router's oversized request comes back as a
    'rejected' finish instead of crashing the serving loop."""
    store = HashStore()
    w = make_worker(store, tiny, "host0", prefill_len=8)
    w.register()
    keys = Keys()
    n = store.add(keys.in_seq(w.chan), 1) - 1
    store.set(keys.inbox(w.chan, n), protocol.dumps(protocol.wire_request(
        0, 0, list(range(20)), 4, None)))
    w.step()
    out = protocol.loads(store.get_nowait(keys.outbox(w.chan, 0)))
    assert out["type"] == "finished" and out["reason"] == "rejected"
    assert w.scheduler.n_active == 0
    assert store.get_nowait(keys.inbox(w.chan, n)) is None   # consumed


def test_duplicate_request_id_rejected(tiny):
    router = Router(HashStore())
    router.submit(Request(prompt=[1, 2], max_new_tokens=2, request_id=5))
    with pytest.raises(ValueError, match="duplicate"):
        router.submit(Request(prompt=[3], max_new_tokens=2, request_id=5))
    with pytest.raises(ValueError, match="max_new_tokens"):
        router.submit(Request(prompt=[3], max_new_tokens=0))
    assert router.submit(Request(prompt=[3], max_new_tokens=2)) == 6


# -- speculative hosts ----------------------------------------------------------------
def test_spec_decode_accept_rate_aggregates_across_hosts(tiny):
    """Speculative hosts stream the greedy tokens (greedy acceptance is the
    exact argmax) and the router sums their accept counts."""
    store = HashStore()
    workers = [make_worker(store, tiny, f"host{i}", spec_k=2, draft_layers=1)
               for i in range(2)]
    for w in workers:
        w.register()
    router = Router(store, heartbeat_ttl_s=30.0)
    prompts, oracles = prompts_and_oracles(tiny, 4, max_new=8, rng_seed=4)
    ids = [router.submit(Request(prompt=p, max_new_tokens=8))
           for p in prompts]
    finished = []
    co_step(router, workers, finished, timeout=120)
    assert sorted(f.request_id for f in finished) == ids
    for f in finished:
        assert f.tokens == oracles[f.request_id]
    stats = router.stats()
    num = sum(w.scheduler.accept_rate.num for w in workers)
    den = sum(w.scheduler.accept_rate.den for w in workers)
    assert den > 0 and stats["accept_rate"] == num / den
    assert set(stats["per_host_accept_rate"]) == {"host0", "host1"}
    assert 0.0 <= stats["accept_rate"] <= 1.0


# -- EOS ----------------------------------------------------------------------------
def test_eos_request_roundtrip_cuts_at_the_first_eos(tiny):
    store = HashStore()
    w = make_worker(store, tiny, "host0")
    w.register()
    router = Router(store)
    prompt = np.asarray([5, 11, 17], np.int64)
    want = oracle(tiny, prompt, 8)
    eos = want[3]
    first = want.index(eos)
    rid = router.submit(Request(prompt=prompt, max_new_tokens=8,
                                eos_token=eos))
    finished = []
    co_step(router, [w], finished)
    (f,) = [x for x in finished if x.request_id == rid]
    assert f.reason == "eos"
    assert f.tokens == want[:first + 1]


def test_eviction_after_the_last_token_finishes_without_a_refeed(tiny):
    """A host that committed its stream's EOS but died before publishing
    the finish: the router finishes the request itself, cut at the EOS."""
    store = HashStore()
    w = make_worker(store, tiny, "host0")
    w.register()
    router = Router(store, heartbeat_ttl_s=0.2)
    prompt = np.asarray([5, 11, 17], np.int64)
    want = oracle(tiny, prompt, 8)
    rid = router.submit(Request(prompt=prompt, max_new_tokens=8,
                                eos_token=want[0]))
    router.step()
    inf = router._inflight[rid]
    w.kill()
    inf.committed = list(want[:3])        # as if chunks arrived, no finish
    time.sleep(0.25)
    (f,) = router.step()
    assert f.reason == "eos" and f.tokens == want[:1]
    assert router.stats()["rebalances"] == 0


# -- a live weight push -----------------------------------------------------------------
def test_push_weights_propagates_with_parity(tiny, tmp_path):
    """The router pushes a port checkpoint of the same weights (written by
    ``CheckpointManager``) to both hosts mid-serve; each loads it once,
    swaps between steps, the versions converge, and every stream is still
    the oracle's. A host that joins after the push gets it too."""
    from pytorch_distributed_tpu_torch.checkpoint import (
        CheckpointManager,
        load_params,
        model_state_dict,
    )

    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(7, model_state_dict(port_model(tiny[2])))
    loads = []

    def loader(ckpt_dir, step):
        loads.append((ckpt_dir, step))
        scratch = GPT2(GPT2Config(**TINY), device="cpu", seed=5)
        assert load_params(ckpt_dir, scratch, step=step) == 7
        return scratch.state_dict()

    store = HashStore()
    workers = [make_worker(store, tiny, f"host{i}", param_loader=loader)
               for i in range(2)]
    for w in workers:
        w.register()
    router = Router(store, heartbeat_ttl_s=30.0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 97, size=5) for _ in range(4)]
    oracles = {i: oracle(tiny, p, 10) for i, p in enumerate(prompts)}
    ids = [router.submit(Request(prompt=p, max_new_tokens=10))
           for p in prompts]
    mark = event_mark()
    finished = router.step()               # discover, route 2 + 2
    for _ in range(2):                     # some tokens before the push
        for w in workers:
            w.step()
        finished.extend(router.step())
    ck = str(tmp_path / "ck")
    assert router.push_weights(ck, step=7) == 1
    co_step(router, workers, finished)
    assert sorted(f.request_id for f in finished) == ids
    for f in finished:
        assert f.tokens == oracles[f.request_id], (
            f"request {f.request_id}: stream diverged across the push")
    assert loads == [(ck, 7)] * 2          # each host loaded once
    assert all(w.weights_version == 1 for w in workers)
    assert all(w.scheduler.weight_swaps == 1 for w in workers)
    stats = router.stats()
    assert stats["weight_pushes"] == 1 and stats["weights_version_min"] == 1
    pushes = [e for e in events_since(mark, "serving.weight_push")
              if e.source == "multihost"]
    assert len(pushes) == 2
    assert all(e.metadata["bytes_moved"] > 0 for e in pushes)
    late = make_worker(store, tiny, "host2", param_loader=loader)
    late.register()
    router.step()                          # discovery forwards the push
    late.step()
    assert late.weights_version == 1 and len(loads) == 3


def test_health_port_serves_the_load_snapshot(tiny):
    import json
    import urllib.request

    store = HashStore()
    w = HostWorker(store, port_scheduler(tiny), host_id="host0",
                   health_port=0)
    w.register()
    try:
        w.step()
        url = f"http://127.0.0.1:{w._health.port}/health"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        assert body["n_slots"] == 2 and body["free_pages"] >= 0
    finally:
        w.kill()
        store.set(w.keys.stop(w.chan), b"1")
        w._killed = False
        w.serve_forever()                  # drains and stops the server
    assert w._health is None


# -- real processes on a TCPStore, one SIGKILLed --------------------------------------
def test_subprocess_worker_sigkill_failover(tiny, tmp_path):
    """Two worker processes over a ``TCPStore``, one SIGKILLed mid-decode:
    every request finishes exactly once with the oracle's stream, the
    master and the router live on, and the survivor drains and exits."""
    weights = tmp_path / "tiny.pt"
    torch.save(tiny[2], weights)
    master = TCPStore("127.0.0.1", 0, is_master=True)
    env = dict(os.environ, MH_PORT=str(master.port),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_port_mh_worker.py"),
         f"host{i}", "0.05", str(weights)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        router = Router(master, heartbeat_ttl_s=3.0)
        prompts, oracles = prompts_and_oracles(tiny, 6, max_new=14,
                                               rng_seed=5)
        ids = [router.submit(Request(prompt=p, max_new_tokens=14))
               for p in prompts]
        finished = []
        deadline = time.monotonic() + 120
        victim_chan = None
        while time.monotonic() < deadline:
            dead = [p for p in procs if p.poll() is not None]
            if dead:
                raise AssertionError("worker died early:\n" + "\n".join(
                    p.communicate()[0].decode() for p in dead))
            finished.extend(router.step())
            started = [inf for inf in router._inflight.values()
                       if inf.chan is not None and inf.committed
                       and len(inf.committed) < inf.max_new_tokens]
            if len(router.hosts) == 2 and started:
                victim_chan = started[0].chan
                break
            time.sleep(0.02)
        assert victim_chan is not None, "workers never started decoding"
        victim = router.hosts[victim_chan]
        idx = int(victim.host.removeprefix("host"))
        os.kill(procs[idx].pid, signal.SIGKILL)
        finished.extend(router.run(timeout_s=120))
        assert sorted(f.request_id for f in finished) == ids
        for f in finished:
            assert f.tokens == oracles[f.request_id], f.request_id
        stats = router.stats()
        assert stats["evictions"] == 1 and stats["rebalances"] >= 1
        assert master.ping()
        router.stop_hosts()
        survivor = procs[1 - idx]
        out = survivor.communicate(timeout=60)[0].decode()
        assert survivor.returncode == 0, out
        assert f"host{1 - idx}: drained, exiting" in out
        assert procs[idx].wait(timeout=10) == -signal.SIGKILL
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        master.close()
