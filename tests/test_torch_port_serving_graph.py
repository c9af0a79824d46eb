"""The serving steps made ready for one program per step, on the CPU.

On the card the engine's decode step and spec round are CUDA graph
replays over static buffers; on the CPU the same step bodies run eagerly
on the same buffers. These tests hold what makes the bodies capturable:

  * the cached forward reading compute-dtype weight copies made once
    (``GPT2.cast_weights``) equals the forward that casts on every call,
    bit for bit, in fp32 and bf16; ``swap_params`` refreshes the copies in
    place, keeping every ``data_ptr``;
  * the slotted cache drops writes past a slot by index arithmetic (no
    boolean mask, which reads back to the host): caches equal to the
    boolean-mask version's and to JAX's ``cached_attention`` bit for bit at
    the window's edge, outputs within fp32 rounding (1e-6);
  * ``speculative.draw`` gives ``torch.multinomial``'s tokens from the
    same generator state, bit for bit;
  * the static-buffer step bodies keep greedy streams token-identical to
    the JAX ``Scheduler``'s for both caches and both drafts, with one
    program per cache object and no replay on the CPU; a new cache gets a
    new program, and a dead cache's program is dropped;
  * the bodies build no autograd graph, even when called with grad mode
    on (as the scheduler's ``prepare`` and the engine's warm-up do).
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.ops.decode_attention import (
    cached_attention as jax_cached_attention,
)
from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
from pytorch_distributed_tpu.serving import Request as JaxRequest
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.ops.decode_attention import cached_attention
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    KVCache,
    PagedKVCache,
    Request,
    Scheduler,
)
from pytorch_distributed_tpu_torch.serving.speculative import draw

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)
DRAFT = dict(vocab_size=97, n_positions=48, n_embd=24, n_layer=1, n_head=2)


def _pair(shape, seed):
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **shape))
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    state = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    model = GPT2(GPT2Config(**shape), device="cpu")
    model.load_state_dict(state)
    return jmodel, variables, model, state


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY, 0)


@pytest.fixture(scope="module")
def tiny_draft():
    return _pair(DRAFT, 1)


# -- compute-dtype weight copies ------------------------------------------
def _cached_run(model, cache_kind, windows):
    """Prefill then decode windows through the cached forward; the logits
    of every call and the final cache."""
    kw = dict(n_slots=2, max_len=24, device="cpu")
    cache = (PagedKVCache.create(model.cfg, page_size=4, **kw)
             if cache_kind == "paged" else KVCache.create(model.cfg, **kw))
    if cache_kind == "paged":
        cache.block_tables.copy_(torch.arange(1, 13).reshape(2, 6))
    out = []
    with torch.no_grad():
        for tokens in windows:
            logits, _ = model(tokens, kv_cache=cache,
                              position_offset=cache.lengths,
                              verify=tokens.shape[1] > 1 and bool(out))
            cache.advance(tokens.shape[1])
            out.append(logits)
    return out, cache


@pytest.mark.parametrize("cache_kind", ["slotted", "paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_copies_equal_per_call_casts(tiny, dtype, cache_kind):
    """Prefill, one-token steps and a verify window: the same logits and
    cache bytes with the copies as with a cast made at every call."""
    state = tiny[3]
    rng = np.random.default_rng(5)
    windows = [torch.from_numpy(rng.integers(0, 97, (2, n)))
               for n in (6, 1, 1, 3, 1)]
    runs = []
    for cast in (False, True):
        model = GPT2(GPT2Config(dtype=dtype, **TINY), device="cpu")
        model.load_state_dict(state)
        if cast:
            model.cast_weights()
            copies = model._copies
            assert len(copies) == len(list(model.parameters()))
            assert all((c is p) == (dtype == torch.float32)
                       and c.dtype == dtype for p, c in copies.items())
        runs.append(_cached_run(model, cache_kind, windows))
    (want, wcache), (got, gcache) = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(gcache.k, wcache.k) and torch.equal(gcache.v, wcache.v)


def test_swap_params_refreshes_copies_in_place(tiny):
    """bf16 compute: the engine's copies follow a swap, each keeping its
    storage; the training forward never reads them."""
    state = tiny[3]
    model = GPT2(GPT2Config(dtype=torch.bfloat16, **TINY), device="cpu")
    model.load_state_dict(state)
    engine = InferenceEngine(model, n_slots=1, max_len=16, prefill_len=8,
                             device="cpu")
    copies = dict(model._copies)
    ptrs = {p: c.data_ptr() for p, c in copies.items()}
    new = {k: v * 0.5 for k, v in state.items()}
    engine.swap_params(new)
    assert all(model._copies[p] is c for p, c in copies.items())
    for name, p in model.named_parameters():
        c = copies[p]
        assert c.data_ptr() == ptrs[p], name
        assert torch.equal(c, new[name].to(torch.bfloat16)), name
    # the training forward casts the parameters themselves
    tokens = torch.from_numpy(np.arange(8)[None] % 97)
    fresh = GPT2(GPT2Config(dtype=torch.bfloat16, **TINY), device="cpu")
    fresh.load_state_dict(new)
    assert torch.equal(model(tokens), fresh(tokens))


# -- the slotted cache's dropped writes ------------------------------------
def _mask_version(q, k_new, v_new, k_cache, v_cache, offset):
    """The writes as a boolean mask drops them (the version the index
    arithmetic replaced, which reads the mask back to the host)."""
    B, T = q.shape[:2]
    S = k_cache.shape[1]
    pos = offset.long()[:, None] + torch.arange(T)
    b_idx = torch.arange(B)[:, None].expand(B, T)
    keep = pos < S
    k_cache[b_idx[keep], pos[keep]] = k_new[keep]
    v_cache[b_idx[keep], pos[keep]] = v_new[keep]


@pytest.mark.parametrize("offsets,T", [([6, 0, 7], 4), ([8, 5, 4], 4),
                                       ([7, 9, 0], 1), ([1, 2, 3], 8)])
def test_slotted_drop_is_sync_free_and_matches(offsets, T):
    """Windows that run past S = 8 (a row wholly past it, one ending on its
    last position, a full-slot window): the caches equal the boolean-mask
    version's and JAX's bit for bit, the outputs JAX's within 1e-6."""
    rng = np.random.default_rng(sum(offsets) + T)
    B, S, H, D = 3, 8, 2, 4
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    kc, vc = (rng.standard_normal((B, S, H, D)).astype(np.float32)
              for _ in range(2))
    off = np.array(offsets, np.int32)
    jout, jk, jv = jax_cached_attention(*map(jnp.asarray, (q, k, v, kc, vc,
                                                           off)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    mk, mv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tq, tkn, tvn, toff = map(torch.from_numpy, (q, k, v, off))
    out, _, _ = cached_attention(tq, tkn, tvn, tk, tv, toff)
    _mask_version(tq, tkn, tvn, mk, mv, toff)
    assert torch.equal(tk, mk) and torch.equal(tv, mv)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=1e-6)


def test_slotted_window_longer_than_the_slot_raises():
    x = torch.zeros(1, 9, 1, 4)
    with pytest.raises(ValueError, match="fit"):
        cached_attention(x, x, x, torch.zeros(1, 8, 1, 4),
                         torch.zeros(1, 8, 1, 4), torch.zeros(1, dtype=torch.int32))


# -- draws ---------------------------------------------------------------------
@pytest.mark.parametrize("V", [2, 97, 50257])
def test_draw_equals_multinomial(V):
    rng = np.random.default_rng(V)
    probs = torch.from_numpy(rng.dirichlet(np.full(V, 0.3), 6)
                             .astype(np.float32))
    probs[0] = 0
    probs[0, V // 2] = 1      # a one-hot row
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    for _ in range(3):
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        assert torch.equal(draw(probs, g2), want)
    assert int(want[0]) == V // 2
    assert torch.equal(g1.get_state(), g2.get_state())


# -- the step bodies on the CPU ----------------------------------------------
FLAVOURS = ["plain", "self_draft", "draft_model"]


@pytest.mark.parametrize("cache_kind", ["slotted", "paged"])
@pytest.mark.parametrize("flavour", FLAVOURS)
def test_step_bodies_keep_jax_streams(tiny, tiny_draft, cache_kind, flavour):
    """Greedy streams through the static-buffer bodies equal the JAX
    ``Scheduler``'s; one program per step kind for the scheduler's cache,
    no graph replay on the CPU."""
    jmodel, variables, model, _ = tiny
    kw = dict(n_slots=2, max_len=32, prefill_len=16, cache_kind=cache_kind)
    if cache_kind == "paged":
        kw["page_size"] = 4
    jkw, pkw = dict(kw), dict(kw)
    if flavour == "self_draft":
        jkw.update(spec_k=2, draft_layers=1)
        pkw.update(spec_k=2, draft_layers=1)
    elif flavour == "draft_model":
        jdraft, dvars, dmodel, dstate = tiny_draft
        jkw.update(spec_k=2, draft_model=jdraft, draft_params=dvars)
        pkw.update(spec_k=2, draft_model=dmodel, draft_params=dstate)
    jsched = JaxScheduler(JaxEngine(jmodel, variables, **jkw),
                          emit_events=False)
    engine = InferenceEngine(model, device="cpu", **pkw)
    sched = Scheduler(engine, emit_events=False)
    rng = np.random.default_rng(7)
    for _ in range(4):
        prompt = rng.integers(0, 97, int(rng.integers(3, 9))).astype(np.int32)
        n_new = int(rng.integers(4, 10))
        jsched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
        sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
    want = {f.request_id: f.tokens for f in jsched.run()}
    got = {f.request_id: f.tokens for f in sched.run()}
    assert got == want
    kinds = sorted(key[0] for key in engine._programs)
    assert kinds == (["decode"] if flavour == "plain" else ["spec"])
    assert engine.replays == 0


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_step_bodies_build_no_autograd_graph(tiny, tiny_draft, flavour):
    """A step body runs without autograd whoever calls it: the scheduler
    builds its program (``prepare``; on the card, the capture) and the
    engine warms the bodies up with grad mode on, and the caches they
    write must not come to require grad (nor keep an autograd graph of
    the step alive in the graph's memory pool)."""
    model = tiny[2]
    kw = dict(n_slots=2, max_len=16, prefill_len=8, cache_kind="paged",
              page_size=4, device="cpu")
    if flavour == "self_draft":
        kw.update(spec_k=2, draft_layers=1)
    elif flavour == "draft_model":
        kw.update(spec_k=2, draft_model=tiny_draft[2],
                  draft_params=tiny_draft[3])
    engine = InferenceEngine(model, **kw)
    sched = Scheduler(engine, emit_events=False)
    assert torch.is_grad_enabled()
    engine._active.fill_(True)
    out = engine._body("spec" if engine.spec_k else "decode", sched.cache,
                       sched.draft_cache)()
    assert not out.requires_grad
    for c in (sched.cache, sched.draft_cache):
        if c is not None:
            assert not (c.k.requires_grad or c.v.requires_grad)


def test_new_cache_gets_new_program_and_dead_cache_drops_it(tiny):
    model = tiny[2]
    engine = InferenceEngine(model, n_slots=2, max_len=16, prefill_len=8,
                             cache_kind="paged", page_size=4, device="cpu")
    last, active = np.array([3, 4]), np.array([True, False])
    first = engine.init_cache()
    engine.decode(first, last, active)
    engine.decode(first, last, active)
    assert len(engine._programs) == 1
    second = engine.init_cache()
    engine.decode(second, last, active)
    assert len(engine._programs) == 2
    assert first.lengths.tolist() == [2, 0]
    assert second.lengths.tolist() == [1, 0]
    del first
    gc.collect()
    assert len(engine._programs) == 1
