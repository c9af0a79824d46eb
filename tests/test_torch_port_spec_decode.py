"""Speculative decoding in the port against the JAX package, on the CPU.

Mirrors ``tests/test_spec_decode.py`` and the speculative case of
``tests/test_paging.py``. On flax-drawn weights copied with
``gpt2_state_dict_from_flax``, greedy speculative serving must emit the JAX
``Scheduler``'s exact token streams for both draft flavours and both cache
kinds. The accept rules are held against the JAX functions; rejection
sampling draws from a ``torch.Generator``, so it is held by its support and
by its distribution (a chi-square test of the emitted marginal). The
verify window runs B7's plain version over flattened rows, held here
against JAX's ``paged_cached_attention`` on the same window.
"""

import functools

import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.ops.decode_attention import (
    cached_attention as jax_cached_attention,
)
from pytorch_distributed_tpu.ops.paged_attention import (
    paged_cached_attention as jax_paged_cached_attention,
)
from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
from pytorch_distributed_tpu.serving import Request as JaxRequest
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.serving import greedy_accept as jax_greedy_accept
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.observability import recent_events
from pytorch_distributed_tpu_torch.ops.decode_attention import cached_attention
from pytorch_distributed_tpu_torch.ops.paged_attention import (
    _scatter_new,
    paged_decode_attention,
)
from pytorch_distributed_tpu_torch.serving import (
    DraftConfig,
    InferenceEngine,
    KVCache,
    PagedKVCache,
    Request,
    SamplingParams,
    Scheduler,
    greedy_accept,
    rejection_accept,
)

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)
DRAFT = dict(vocab_size=97, n_positions=48, n_embd=24, n_layer=1, n_head=2)


def _pair(shape, seed):
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **shape))
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    model = GPT2(GPT2Config(**shape), device="cpu")
    model.load_state_dict(gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def tiny_draft():
    return _pair(DRAFT, 1)


def _draft_params(variables):
    return gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))


@functools.lru_cache(maxsize=None)
def _oracle_fwd(jmodel):
    return jax.jit(jmodel.apply)


def greedy_oracle(jmodel, variables, prompt, n_tokens):
    """Teacher forcing through the JAX model's uncached forward, padded to
    ``n_positions`` (causal attention hides the padded tail)."""
    fwd = _oracle_fwd(jmodel)
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n_tokens):
        buf = np.zeros((1, jmodel.cfg.n_positions), np.int32)
        buf[0, :len(seq)] = seq
        logits = fwd(variables, jnp.asarray(buf))
        out.append(int(jnp.argmax(logits[0, len(seq) - 1])))
        seq.append(out[-1])
    return out


def _serve(jax_side, reqs, **kw):
    """The same requests through the JAX and the port's scheduler."""
    (jmodel, variables), (model, draft) = jax_side
    jkw, pkw = dict(kw), dict(kw)
    if draft is not None:
        jdraft, dvars, dmodel = draft
        jkw.update(draft_model=jdraft, draft_params=dvars)
        pkw.update(draft_model=dmodel, draft_params=_draft_params(dvars))
    jsched = JaxScheduler(JaxEngine(jmodel, variables, **jkw),
                          emit_events=False)
    sched = Scheduler(InferenceEngine(model, device="cpu", **pkw),
                      emit_events=False)
    for prompt, n_new in reqs:
        jsched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
        sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
    want = {f.request_id: f.tokens for f in jsched.run()}
    got = {f.request_id: f.tokens for f in sched.run()}
    return got, want, sched, jsched


def _churn(seed, n, n_new=(3, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, int(rng.integers(2, 8))).astype(np.int32),
             int(rng.integers(*n_new))) for _ in range(n)]


# -- acceptance math -------------------------------------------------------
def test_greedy_accept_matches_jax():
    rng = np.random.default_rng(0)
    S, k, V = 6, 4, 11
    logits = rng.standard_normal((S, k + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    draft = rng.integers(0, V, (S, k))
    # rows with 0..k matching proposals, then a mismatch
    for s in range(S):
        n = min(s, k)
        draft[s, :n] = tgt[s, :n]
        if n < k:
            draft[s, n] = (tgt[s, n] + 1) % V
    ja, je = jax_greedy_accept(jnp.asarray(logits),
                               jnp.asarray(draft, jnp.int32))
    a, e = greedy_accept(torch.from_numpy(logits), torch.from_numpy(draft))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert a.tolist() == [0, 1, 2, 3, 4, 4]


def test_rejection_accept_full_accept_when_draft_equals_target():
    """p_d == p_t makes ``u * p < p`` always true: every proposal survives
    and position k emits the bonus from p_t[k]."""
    rng = np.random.default_rng(0)
    S, k, V = 3, 4, 13
    pt = torch.from_numpy(rng.dirichlet(np.ones(V), (S, k + 1))
                          .astype(np.float32))
    draft = torch.from_numpy(rng.integers(0, V, (S, k)))
    accepts, emitted = rejection_accept(pt, pt[:, :k], draft,
                                        torch.Generator().manual_seed(0))
    assert accepts.tolist() == [k] * S
    assert torch.equal(emitted[:, :k], draft)
    assert all(0 <= int(t) < V for t in emitted[:, k])


def test_rejection_accept_rejects_impossible_tokens():
    """A draft token the target gives zero probability is rejected and the
    replacement comes from the target's support."""
    S, k, V = 4, 2, 8
    pt = torch.zeros(S, k + 1, V)
    pt[..., 0] = 1.0          # the target is a point mass on token 0
    pd = torch.zeros(S, k, V)
    pd[..., 5] = 1.0          # the draft always proposes token 5
    draft = torch.full((S, k), 5)
    accepts, emitted = rejection_accept(pt, pd, draft,
                                        torch.Generator().manual_seed(1))
    assert accepts.tolist() == [0] * S
    assert emitted[:, 0].tolist() == [0] * S


def test_rejection_accept_marginal_is_the_target_distribution():
    """The first emitted token of every row is distributed as p_t[0],
    whatever the draft (Leviathan et al., Theorem 1): 20,000 rows at V=5,
    a chi-square test at p > 1e-3."""
    n, k, V = 20_000, 2, 5
    p_t = np.array([0.40, 0.25, 0.15, 0.12, 0.08])
    p_d = np.array([0.05, 0.15, 0.30, 0.20, 0.30])
    rng = np.random.default_rng(7)
    draft = rng.choice(V, size=(n, k), p=p_d)
    pt = torch.tensor(p_t, dtype=torch.float32).expand(n, k + 1, V)
    pd = torch.tensor(p_d, dtype=torch.float32).expand(n, k, V)
    _, emitted = rejection_accept(pt.contiguous(), pd.contiguous(),
                                  torch.from_numpy(draft),
                                  torch.Generator().manual_seed(3))
    counts = np.bincount(emitted[:, 0].numpy(), minlength=V)
    assert sps.chisquare(counts, p_t * n).pvalue > 1e-3, counts


# -- configuration ---------------------------------------------------------
def test_draft_config_validation():
    DraftConfig(k=2, draft_layers=1).validate(2)
    with pytest.raises(ValueError, match="spec_k"):
        DraftConfig(k=0, draft_layers=1).validate(2)
    with pytest.raises(ValueError, match="exactly one draft source"):
        DraftConfig(k=2).validate(2)
    with pytest.raises(ValueError, match="exactly one draft source"):
        DraftConfig(k=2, draft_layers=1, use_draft_model=True).validate(2)
    with pytest.raises(ValueError, match="draft_layers"):
        DraftConfig(k=2, draft_layers=3).validate(2)


def test_engine_spec_validation(tiny, tiny_draft):
    _, _, model = tiny
    _, dvars, dmodel = tiny_draft
    with pytest.raises(ValueError, match="require spec_k"):
        InferenceEngine(model, draft_layers=1, device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        InferenceEngine(model, spec_k=2, draft_model=dmodel, device="cpu")
    with pytest.raises(ValueError, match="no room"):
        InferenceEngine(model, max_len=3, prefill_len=2, spec_k=2,
                        draft_layers=1, device="cpu")
    with pytest.raises(ValueError, match="draft_layers"):
        InferenceEngine(model, spec_k=2, draft_layers=3, device="cpu")
    bad = GPT2(GPT2Config(**dict(DRAFT, vocab_size=96)), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(model, spec_k=2, draft_model=bad,
                        draft_params=bad.state_dict(), device="cpu")
    with pytest.raises(RuntimeError, match="spec_k=0"):
        InferenceEngine(model, device="cpu").spec_decode(
            None, None, np.zeros(8), np.zeros(8), np.zeros(8, bool))


def test_truncated_forward_validation(tiny):
    _, _, model = tiny
    cache = KVCache.create(model.cfg, n_slots=1, max_len=8, device="cpu")
    tokens = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="requires kv_cache"):
        model(tokens, n_layers=1)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="n_layers"):
            model(tokens, kv_cache=cache, n_layers=bad)


def test_truncated_forward_writes_only_its_layers(tiny):
    """The self-draft's forward writes layer 0's K/V and leaves layer 1's
    alone; its layer-0 K/V equal the full forward's."""
    _, _, model = tiny
    tokens = torch.tensor([[5, 17, 3]])
    full = KVCache.create(model.cfg, n_slots=1, max_len=8, device="cpu")
    part = KVCache.create(model.cfg, n_slots=1, max_len=8, device="cpu")
    with torch.no_grad():
        model(tokens, kv_cache=full)
        model(tokens, kv_cache=part, n_layers=1)
    assert torch.equal(part.k[0], full.k[0])
    assert torch.equal(part.v[0], full.v[0])
    assert not part.k[1].any() and not part.v[1].any()


# -- the ops under the spec window ------------------------------------------
def test_slotted_write_past_the_slot_is_dropped():
    """Near a slot's end the window writes past S: those writes are
    dropped, as JAX's ``.at[].set`` drops them. The caches match bit for
    bit, the outputs within fp32 rounding (as inside the slot)."""
    rng = np.random.default_rng(4)
    B, T, S, H, D = 3, 4, 8, 2, 4
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    kc, vc = (rng.standard_normal((B, S, H, D)).astype(np.float32)
              for _ in range(2))
    off = np.array([6, 0, 7], np.int32)   # rows 0 and 2 run past S
    jout, jk, jv = jax_cached_attention(*map(jnp.asarray, (q, k, v, kc, vc,
                                                           off)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, _, _ = cached_attention(*map(torch.from_numpy, (q, k, v)), tk, tv,
                                 torch.from_numpy(off))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=1e-6)


def _paged_window(seed, offsets, B=4, T=4, H=4, D=12, page=4, M=8):
    """A window of T new tokens per row over a shuffled page pool; the
    last row's table is all zero (an inactive slot: the trash page)."""
    rng = np.random.default_rng(seed)
    P = B * M + 1
    tables = np.zeros((B, M), np.int32)
    perm = rng.permutation(P - 1) + 1
    for b in range(B - 1):
        tables[b] = perm[b * M:(b + 1) * M]
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    kp, vp = (rng.standard_normal((P, page, H, D)).astype(np.float32)
              for _ in range(2))
    return q, k, v, kp, vp, tables, np.array(offsets, np.int32)


OFFSETS = {"inside": [5, 13, 0, 29], "past_the_table": [29, 30, 31, 0]}


@pytest.mark.parametrize("offsets", list(OFFSETS.values()),
                         ids=list(OFFSETS))
def test_verify_rows_match_jax_paged_cached_attention(offsets):
    """B7's plain version over ``B*T`` flattened rows (table rows repeated
    T times, row positions base+i) after the window's scatter equals JAX's
    ``paged_cached_attention`` over the window, fp32, within 2e-5; the
    pools match bit for bit (writes past the table go to the trash page
    in both)."""
    q, k, v, kp, vp, tables, off = _paged_window(9, offsets)
    B, T, H, D = q.shape
    jout, jk, jv = jax_paged_cached_attention(
        *map(jnp.asarray, (q, k, v, kp, vp, tables, off)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tbl = torch.from_numpy(tables)
    pos = torch.from_numpy(off)[:, None] + torch.arange(T, dtype=torch.int32)
    _scatter_new(tk, torch.from_numpy(k), tbl, pos)
    _scatter_new(tv, torch.from_numpy(v), tbl, pos)
    out = paged_decode_attention(
        torch.from_numpy(q).reshape(B * T, 1, H, D), tk, tv,
        tbl.repeat_interleave(T, dim=0), pos.reshape(-1))
    np.testing.assert_allclose(out.reshape(B, T, H, D).numpy(),
                               np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("offsets", list(OFFSETS.values()),
                         ids=list(OFFSETS))
def test_model_verify_window_matches_jax(tiny, offsets):
    """The model's verify forward (``verify=True``: the rows route) against
    the JAX model's cached forward over the same paged window (the plain
    gather): logits within 1e-4 x their largest, pools within 2e-5."""
    jmodel, variables, model = tiny
    _, _, _, kp, vp, tables, off = _paged_window(11, offsets, H=4, D=12)
    L = model.cfg.n_layer
    rng = np.random.default_rng(12)
    k_pool = rng.standard_normal((L,) + kp.shape).astype(np.float32)
    v_pool = rng.standard_normal((L,) + vp.shape).astype(np.float32)
    window = rng.integers(0, 97, (len(off), 4)).astype(np.int32)
    from pytorch_distributed_tpu.serving.paging import (
        PagedKVCache as JaxPagedKVCache,
    )
    jcache = JaxPagedKVCache(k=jnp.asarray(k_pool), v=jnp.asarray(v_pool),
                             block_tables=jnp.asarray(tables),
                             lengths=jnp.asarray(off))
    jlogits, jcache = jmodel.apply(variables, jnp.asarray(window),
                                   kv_cache=jcache,
                                   position_offset=jnp.asarray(off))
    cache = PagedKVCache(k=torch.from_numpy(k_pool.copy()),
                         v=torch.from_numpy(v_pool.copy()),
                         block_tables=torch.from_numpy(tables),
                         lengths=torch.from_numpy(off.copy()))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(window), kv_cache=cache,
                          position_offset=torch.from_numpy(off), verify=True)
    jl = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jl,
                               atol=1e-4 * np.abs(jl).max(), rtol=0)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v),
                               atol=2e-5, rtol=0)


# -- greedy streams against the JAX Scheduler -------------------------------
KINDS = {"slotted": {}, "paged": {"page_size": 4}}


@pytest.mark.parametrize("cache_kind", list(KINDS))
@pytest.mark.parametrize("spec_k,draft_layers", [(1, 1), (2, 1), (3, 2)])
def test_self_draft_streams_match_jax(tiny, cache_kind, spec_k, draft_layers):
    jmodel, variables, model = tiny
    got, want, sched, jsched = _serve(
        ((jmodel, variables), (model, None)), _churn(5, 5),
        n_slots=2, max_len=32, prefill_len=8, cache_kind=cache_kind,
        spec_k=spec_k, draft_layers=draft_layers, **KINDS[cache_kind])
    assert got == want
    stats, jstats = sched.stats(), jsched.stats()
    assert stats["accept_rate"] == jstats["accept_rate"]
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert stats["spec_proposed"] == sched.accept_rate.den > 0


@pytest.mark.parametrize("cache_kind", list(KINDS))
def test_draft_model_streams_and_churn_match_jax(tiny, tiny_draft,
                                                 cache_kind):
    """The separate draft (its own slotted cache, prefilled at admission,
    caught up by the [S, 2] refeed) under join/evict churn through 2 slots:
    the JAX streams, and the JAX accept counts."""
    jmodel, variables, model = tiny
    got, want, sched, jsched = _serve(
        ((jmodel, variables), (model, tiny_draft)), _churn(5, 5, (2, 8)),
        n_slots=2, max_len=32, prefill_len=8, cache_kind=cache_kind,
        spec_k=2, **KINDS[cache_kind])
    assert sched.draft_cache is not None
    assert got == want
    assert sched.accept_rate.num == jsched.accept_rate.num
    assert sched.accept_rate.den == jsched.accept_rate.den


@pytest.mark.parametrize("cache_kind", list(KINDS))
def test_full_layer_self_draft_accepts_everything(tiny, cache_kind):
    """draft_layers == n_layer makes the draft the target itself: every
    greedy proposal is the target argmax, so every round accepts all k."""
    jmodel, variables, model = tiny
    k = 3
    prompt = np.array([5, 17, 3], np.int32)
    engine = InferenceEngine(model, n_slots=1, max_len=32, prefill_len=8,
                             cache_kind=cache_kind, spec_k=k,
                             draft_layers=model.cfg.n_layer, device="cpu",
                             **KINDS[cache_kind])
    sched = Scheduler(engine, emit_events=False)
    sched.submit(Request(prompt=prompt, max_new_tokens=1 + 3 * (k + 1)))
    (fin,) = sched.run()
    assert sched.accept_rate.rate() == 1.0
    assert sched.decode_steps == 3
    assert fin.tokens == greedy_oracle(jmodel, variables, prompt,
                                       1 + 3 * (k + 1))


def test_spec_rollback_commits_only_accepted_span(tiny):
    """lengths advance by exactly ``counts`` per round, inactive slots do
    not move, and the verify starts from a copy of the lengths (the cache's
    own tensor is moved in place by ``advance``)."""
    _, _, model = tiny
    engine = InferenceEngine(model, n_slots=3, max_len=32, prefill_len=8,
                             spec_k=2, draft_layers=1, device="cpu")
    cache = engine.init_cache()
    lengths = cache.lengths
    cache, tok = engine.prefill(cache, 1, np.array([4, 8, 15], np.int32))
    last, prev = np.zeros(3, np.int64), np.zeros(3, np.int64)
    active = np.zeros(3, bool)
    last[1], prev[1], active[1] = tok, 15, True
    total = 0
    for _ in range(3):
        before = cache.lengths.tolist()
        cache, _, emitted, counts, prev_next = engine.spec_decode(
            cache, None, last, prev, active)
        n = int(counts[1])
        assert 1 <= n <= 3
        assert cache.lengths.tolist() == [0, before[1] + n, 0]
        assert counts[0] == counts[2] == 0
        total += n
        last[1], prev[1] = emitted[1, n - 1], prev_next[1]
    assert cache.lengths is lengths  # updated in place
    assert int(cache.lengths[1]) == 3 + total


def test_kv_cache_advance_and_rollback(tiny):
    """The reference's ``advance(n [S], active)`` and ``rollback(lengths)``
    on both cache kinds, in place; rolling back to a copy restores it."""
    _, _, model = tiny
    for cache in (KVCache.create(model.cfg, n_slots=3, max_len=16,
                                 device="cpu"),
                  PagedKVCache.create(model.cfg, n_slots=3, max_len=16,
                                      page_size=4, device="cpu")):
        cache.lengths.copy_(torch.tensor([4, 7, 0]))
        base = cache.lengths.clone()
        cache.advance(torch.tensor([2, 3, 1], dtype=torch.int32),
                      torch.tensor([True, False, True]))
        assert cache.lengths.tolist() == [6, 7, 1]
        assert base.tolist() == [4, 7, 0]
        cache.rollback(base)
        assert cache.lengths.tolist() == [4, 7, 0]


def test_paged_spec_releases_rejected_pages(tiny):
    """Speculative decode over the paged cache: streams equal the slotted
    spec path's, and the page-granular rollback returns every page of the
    rejected spans (the reservation ledger drains to zero, every non-radix
    page is back in the pool)."""
    jmodel, variables, model = tiny
    reqs = _churn(5, 5)
    streams = {}
    for kind in KINDS:
        sched = Scheduler(InferenceEngine(
            model, n_slots=2, max_len=32, prefill_len=8, cache_kind=kind,
            spec_k=3, draft_layers=1, device="cpu", **KINDS[kind]),
            emit_events=False)
        for prompt, n_new in reqs:
            sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
        streams[kind] = {f.request_id: f.tokens for f in sched.run()}
    assert streams["paged"] == streams["slotted"]
    alloc = sched.allocator
    alloc.check()
    assert alloc.reserved.sum() == 0
    pinned = (alloc.refcount[1:] > 0).sum()
    assert alloc.free_pages == alloc.n_pages - 1 - pinned


@pytest.mark.parametrize("cache_kind", list(KINDS))
def test_spec_window_at_the_end_of_the_slot(tiny, cache_kind):
    """Prompt + budget reach max_len (= n_positions) under spec_k = 3: the
    draft and verify windows write up to 3 positions past the slot. The
    port drops those writes (slotted) or sends them to the trash page
    (paged) and emits the JAX streams, which here equal the uncached
    argmax."""
    jmodel, variables, model = tiny
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(0, 97, 40).astype(np.int32), 8),
            (rng.integers(0, 97, 38).astype(np.int32), 12)]
    got, want, sched, _ = _serve(
        ((jmodel, variables), (model, None)), reqs, n_slots=2, max_len=48,
        prefill_len=40, cache_kind=cache_kind, spec_k=3, draft_layers=1,
        **KINDS[cache_kind])
    oracle = {i: greedy_oracle(jmodel, variables, p, len(want[i]))
              for i, (p, _) in enumerate(reqs)}
    assert got == want == oracle
    # request 1 stops at capacity: its next write would be position 48
    assert [len(got[i]) for i in range(2)] == [8, 11]
    if cache_kind == "paged":
        sched.allocator.check()
        assert sched.allocator.reserved.sum() == 0


def test_spec_step_events_trace_accept_counts(tiny):
    """The ``serving.spec_step`` events reconcile with the scheduler's
    accounting: accepted <= proposed, every consumed span in [1, k+1], and
    the totals equal the accept-rate counters."""
    _, _, model = tiny
    k = 2
    engine = InferenceEngine(model, n_slots=2, max_len=32, prefill_len=8,
                             spec_k=k, draft_layers=1, device="cpu")
    sched = Scheduler(engine)
    for i in range(3):
        sched.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=6))
    sched.run()
    evs = [e for e in recent_events(500) if e.name == "serving.spec_step"]
    evs = evs[-sched.decode_steps:]
    assert len(evs) == sched.decode_steps > 0
    proposed = accepted = 0
    for e in evs:
        md = e.metadata
        assert 0 <= md["accepted"] <= md["proposed"]
        assert md["proposed"] % k == 0
        assert all(1 <= c <= k + 1 for c in md["consumed"].values())
        proposed += md["proposed"]
        accepted += md["accepted"]
    stats = sched.stats()
    assert proposed == stats["spec_proposed"] == sched.accept_rate.den
    assert accepted == stats["spec_accepted"] == sched.accept_rate.num
    assert sched.tokens_generated == 3 * 6


@pytest.mark.parametrize("flavour", ["self", "draft_model"])
def test_stochastic_spec_decode_stays_in_support(tiny, tiny_draft, flavour):
    """Rejection sampling through the engine: spans of 1..k+1 tokens, every
    token inside the top-k support, lengths consistent after the rounds,
    and the same seed gives the same stream."""
    _, _, model = tiny
    k = 2
    kw = dict(draft_layers=1)
    if flavour == "draft_model":
        _, dvars, dmodel = tiny_draft
        kw = dict(draft_model=dmodel, draft_params=_draft_params(dvars))
    streams = []
    for _ in range(2):
        engine = InferenceEngine(
            model, n_slots=2, max_len=32, prefill_len=8, spec_k=k,
            sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.95),
            seed=3, device="cpu", **kw)
        cache, dcache = engine.init_cache(), engine.init_draft_cache()
        prompt = np.array([3, 1, 4], np.int32)
        if dcache is not None:
            engine.prefill_draft(dcache, 0, prompt)
        cache, tok = engine.prefill(cache, 0, prompt)
        last, prev = np.array([tok, 0]), np.array([4, 0])
        active = np.array([True, False])
        got = [tok]
        for _ in range(4):
            cache, dcache, emitted, counts, prev_next = engine.spec_decode(
                cache, dcache, last, prev, active)
            n = int(counts[0])
            assert 1 <= n <= k + 1
            got.extend(int(t) for t in emitted[0, :n])
            last[0], prev[0] = emitted[0, n - 1], prev_next[0]
        assert int(cache.lengths[0]) == 3 + len(got) - 1
        if dcache is not None:
            assert torch.equal(dcache.lengths, cache.lengths)
        streams.append(got)
    assert streams[0] == streams[1]
    assert all(0 <= t < 97 for t in streams[0])
