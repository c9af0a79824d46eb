"""The port's engine and scheduler against the JAX package's, on the CPU.

Greedy serving leaves no tolerance: on the same weights (flax-drawn, copied
with ``gpt2_state_dict_from_flax``) the port's ``Scheduler`` must emit the
JAX ``Scheduler``'s exact token streams for both cache kinds, under mixed
churn, shared prefixes (radix hits), a whole-prompt COW fork, slot reuse
and page-pool backpressure. Stochastic sampling uses other RNGs than JAX,
so it is held by its support only. The guards check that the port never
loads JAX or the JAX package and never falls back to the CPU unasked.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
from pytorch_distributed_tpu.serving import Request as JaxRequest
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.observability import (
    get_metrics,
    recent_events,
)
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    KVCache,
    PagedKVCache,
    Request,
    SamplingParams,
    Scheduler,
    sample_tokens,
)
from pytorch_distributed_tpu_torch.serving.paging import TRASH_PAGE, fork_pages

torch.set_num_threads(2)

REPO = Path(__file__).parent.parent
TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **TINY))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    model = GPT2(GPT2Config(**TINY), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model.load_state_dict(gpt2_state_dict_from_flax(params))
    return jmodel, variables, model


def _requests(scenario):
    if scenario == "churn":
        # tests/test_paging.py's mixed-churn set: shared 2-page prefix,
        # a whole-prompt repeat (COW fork), unrelated prompts
        rng = np.random.default_rng(3)
        shared = rng.integers(0, 97, 8).astype(np.int32)
        return [
            (rng.integers(0, 97, 5).astype(np.int32), 6),
            (np.concatenate([shared, rng.integers(0, 97, 3)]).astype(np.int32), 5),
            (np.concatenate([shared, rng.integers(0, 97, 2)]).astype(np.int32), 4),
            (shared.copy(), 6),
            (rng.integers(0, 97, 7).astype(np.int32), 3),
        ]
    if scenario == "slot_reuse":
        return [(np.array([60, 61, 62, 63], np.int32), 10),
                (np.array([7, 1], np.int32), 8)]
    # backpressure: a pool too small for two worst-case spans
    return [(np.arange(4, dtype=np.int32) + i, 6) for i in range(3)]


SCENARIOS = {
    ("slotted", "churn"): dict(n_slots=2, max_len=32, prefill_len=16),
    ("paged", "churn"): dict(n_slots=2, max_len=32, prefill_len=16,
                             page_size=4),
    ("paged", "slot_reuse"): dict(n_slots=1, max_len=32, prefill_len=8,
                                  page_size=4),
    ("paged", "backpressure"): dict(n_slots=2, max_len=16, prefill_len=8,
                                    page_size=4, n_pages=4),
}


@pytest.mark.parametrize("cache_kind,scenario", list(SCENARIOS))
def test_scheduler_streams_match_jax(models, cache_kind, scenario):
    jmodel, variables, model = models
    kw = dict(SCENARIOS[(cache_kind, scenario)], cache_kind=cache_kind)
    reqs = _requests(scenario)
    jsched = JaxScheduler(JaxEngine(jmodel, variables, **kw),
                          emit_events=False)
    sched = Scheduler(InferenceEngine(model, device="cpu", **kw),
                      emit_events=False)
    for prompt, n_new in reqs:
        jsched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
        sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
    want = {f.request_id: f.tokens for f in jsched.run()}
    got = {f.request_id: f.tokens for f in sched.run()}
    assert got == want
    stats, jstats = sched.stats(), jsched.stats()
    # the port also counts weight swaps in stats()
    assert sorted(stats) == sorted([*jstats, "weight_swaps"])
    assert stats["cache_kind"] == cache_kind
    assert stats["tokens_generated"] == jstats["tokens_generated"]
    assert stats["decode_steps"] == jstats["decode_steps"]
    if cache_kind == "paged":
        sched.allocator.check()
        assert sched.allocator.reserved.sum() == 0
        for key in ("radix_hits", "radix_misses", "prefill_tokens_cached",
                    "free_pages"):
            assert stats[key] == jstats[key], key
        if scenario == "churn":
            assert stats["radix_hits"] >= 2


def test_caches_update_in_place(models):
    _, _, model = models
    cache = PagedKVCache.create(model.cfg, n_slots=3, max_len=16,
                                page_size=4, device="cpu")
    assert cache.k.shape == (2, 3 * 4 + 1, 4, 4, 12)
    assert cache.block_tables.shape == (3, 4)
    cache.set_table_row(1, [5, 6, 7, 8])
    cache.advance(torch.tensor([1, 9, 2], dtype=torch.int32),
                  torch.tensor([False, True, True]))
    assert cache.lengths.tolist() == [0, 9, 2]
    cache.k[:, 6] = 1.0
    cache.v[:, 6] = 2.0
    fork_pages(cache, 6, 3)
    assert torch.equal(cache.k[:, 3], cache.k[:, 6])
    assert torch.equal(cache.v[:, 3], cache.v[:, 6])
    # eviction zeroes the table row: the slot's padding-lane writes and
    # reads land in the trash page, never a live page
    cache.evict(1)
    assert cache.lengths[1] == 0
    assert (cache.block_tables[1] == TRASH_PAGE).all()
    cache.rollback([4, 0, 1])
    assert cache.lengths.tolist() == [4, 0, 1]
    with pytest.raises(ValueError, match="n_pages"):
        PagedKVCache.create(model.cfg, n_slots=1, max_len=8, page_size=4,
                            n_pages=1, device="cpu")

    slotted = KVCache.create(model.cfg, n_slots=2, max_len=8, device="cpu")
    assert slotted.k.shape == (2, 2, 8, 4, 12)
    slotted.advance(3)
    slotted.evict(0)
    assert slotted.lengths.tolist() == [0, 3]
    with pytest.raises(ValueError, match="n_positions"):
        KVCache.create(model.cfg, n_slots=1, max_len=4096, device="cpu")


def test_scheduler_records_events_and_metrics(models):
    _, _, model = models
    before = get_metrics().get("serving.requests_finished", 0.0)
    sched = Scheduler(InferenceEngine(model, n_slots=2, max_len=16,
                                      prefill_len=8, device="cpu"))
    for prompt in ([1, 2, 3], [4, 5]):
        sched.submit(Request(prompt=np.array(prompt), max_new_tokens=3))
    sched.run()
    assert get_metrics()["serving.requests_finished"] == before + 2
    events = recent_events(4)
    assert [e.name for e in events].count("serving.admit") == 2
    done = [e.metadata for e in events if e.name == "serving.request_finished"]
    assert sorted(m["request_id"] for m in done) == [0, 1]
    assert all(m["new_tokens"] == 3 and m["reason"] == "length" for m in done)


# -- sampling --------------------------------------------------------------
def test_sample_greedy_is_argmax():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((5, 33)).astype(np.float32))
    toks = sample_tokens(logits, None, SamplingParams())
    np.testing.assert_array_equal(toks.numpy(), np.argmax(logits.numpy(), -1))


def test_sample_top_k_restricts_support():
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((4, 50)).astype(np.float32))
    top5 = np.argsort(logits.numpy(), -1)[:, -5:]
    gen = torch.Generator().manual_seed(0)
    sp = SamplingParams(temperature=1.0, top_k=5)
    for _ in range(20):
        toks = sample_tokens(logits, gen, sp).numpy()
        for row in range(4):
            assert toks[row] in top5[row]


def test_sample_top_p_keeps_best_token_when_peaked():
    logits = np.full((3, 20), -5.0, np.float32)
    best = [4, 11, 0]
    for r, b in enumerate(best):
        logits[r, b] = 10.0
    gen = torch.Generator().manual_seed(0)
    sp = SamplingParams(temperature=1.0, top_p=0.5)
    for _ in range(5):
        toks = sample_tokens(torch.from_numpy(logits), gen, sp)
        np.testing.assert_array_equal(toks.numpy(), best)


def test_sample_top_k_exact_k_with_ties():
    """Ties with the k-th value break toward lower token ids: the support
    is exactly k tokens, never widened by a tie."""
    logits = np.full((2, 16), -10.0, np.float32)
    logits[0, [3, 7, 11]] = 2.0
    logits[1, [0, 1, 2, 3]] = 5.0
    gen = torch.Generator().manual_seed(0)
    sp = SamplingParams(temperature=1.0, top_k=2)
    seen = [set(), set()]
    for _ in range(40):
        toks = sample_tokens(torch.from_numpy(logits), gen, sp).numpy()
        for row in range(2):
            seen[row].add(int(toks[row]))
    assert seen[0] <= {3, 7}, seen[0]
    assert seen[1] <= {0, 1}, seen[1]


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(top_p=0.0).validate()
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1).validate()


@pytest.mark.parametrize("cache_kind", ["slotted", "paged"])
def test_stochastic_serving_stays_in_support(models, cache_kind):
    _, _, model = models
    engine = InferenceEngine(
        model, n_slots=2, max_len=24, prefill_len=8, cache_kind=cache_kind,
        page_size=4, sampling=SamplingParams(temperature=0.8, top_k=10),
        seed=7, device="cpu")
    sched = Scheduler(engine, emit_events=False)
    sched.submit(Request(prompt=np.array([3, 1, 4], np.int32),
                         max_new_tokens=8))
    (fin,) = sched.run()
    assert len(fin.tokens) == 8 and all(0 <= t < 97 for t in fin.tokens)


# -- engine validation and guards --------------------------------------------
def test_engine_validation(models):
    _, _, model = models
    engine = InferenceEngine(model, n_slots=2, max_len=16, prefill_len=8,
                             device="cpu")
    cache = engine.init_cache()
    with pytest.raises(ValueError, match="empty"):
        engine.prefill(cache, 0, np.array([], np.int32))
    with pytest.raises(ValueError, match="exceeds prefill_len"):
        engine.prefill(cache, 0, np.arange(9, dtype=np.int32))
    with pytest.raises(ValueError, match="slot"):
        engine.prefill(cache, 5, np.array([1], np.int32))
    with pytest.raises(ValueError, match="cached_len"):
        engine.prefill(cache, 0, np.array([1, 2], np.int32), cached_len=1)
    with pytest.raises(ValueError, match="prefill_len"):
        InferenceEngine(model, n_slots=2, max_len=8, prefill_len=9,
                        device="cpu")
    with pytest.raises(ValueError, match="cache_kind"):
        InferenceEngine(model, cache_kind="ring", device="cpu")


def test_prefill_bucket_selection(models):
    _, _, model = models
    engine = InferenceEngine(model, n_slots=2, max_len=48, prefill_len=24,
                             device="cpu")
    assert engine.prefill_buckets == (8, 16, 24)
    assert [engine.prefill_bucket(n) for n in (1, 8, 9, 24)] == [8, 8, 16, 24]
    with pytest.raises(ValueError, match="exceeds prefill_len"):
        engine.prefill_bucket(25)
    padded, n = engine._pad_prompt(np.arange(1, 11))
    assert padded.shape == (1, 16) and n == 10
    custom = InferenceEngine(model, n_slots=2, max_len=48, prefill_len=24,
                             prefill_buckets=(4, 12), device="cpu")
    assert custom.prefill_buckets == (4, 12, 24)  # cap appended
    with pytest.raises(ValueError, match="exceeds prefill_len"):
        InferenceEngine(model, n_slots=2, max_len=48, prefill_len=8,
                        prefill_buckets=(16,), device="cpu")


@pytest.mark.parametrize("buckets", [(8,), (16,), (5, 7)])
def test_greedy_stream_independent_of_prefill_bucket(models, buckets):
    """Padding is invisible to the cache: the paged engine's greedy stream
    equals the argmax continuation of its own uncached forward, whichever
    bucket the prompt pads to."""
    _, _, model = models
    prompt = [5, 17, 3, 9, 44]
    seq = list(prompt)
    with torch.no_grad():
        for _ in range(8):
            seq.append(int(torch.argmax(model(torch.tensor([seq]))[0, -1])))
    engine = InferenceEngine(model, n_slots=2, max_len=32, prefill_len=16,
                             prefill_buckets=buckets, cache_kind="paged",
                             page_size=4, device="cpu")
    sched = Scheduler(engine, emit_events=False)
    sched.submit(Request(prompt=np.array(prompt), max_new_tokens=8))
    (fin,) = sched.run()
    assert fin.tokens == seq[len(prompt):]


@pytest.mark.parametrize("kwargs", [dict(cache_sharding=object())])
def test_unported_options_raise(models, kwargs, tmp_path):
    """``cache_sharding`` (ported by ROADMAP A.15c) is accepted: a model
    cut over a one-rank ``(dp, tp)`` mesh, its cache on tp, emits the
    whole model's greedy stream (in a process of its own with its gloo
    group; multi-rank streams: ``tests/test_torch_port_tp_serving.py``); a
    value that is not a ``CacheSharding`` is refused."""
    from tests import _torch_port_ranks as ranks
    from tests import _torch_port_tp as tph

    _, _, model = models
    with pytest.raises(AttributeError):
        InferenceEngine(model, device="cpu", **kwargs)
    ranks.finish(ranks.start(tph.cut_stream_body, tmp_path,
                             model.state_dict(), TINY, world=1))
    out = torch.load(tmp_path / "cut_stream.pt")
    assert out[True] == out[False] and len(out[True]) == 8


def test_entry_points_default_to_the_card(models):
    """Without ``device=`` the entry points want the CUDA card and raise
    here (no card) instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, model = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2(GPT2Config(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(model.cfg, n_slots=1, max_len=8)


_IMPORT_GUARD = """
import importlib, pkgutil, sys
import pytorch_distributed_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
banned = ("jax", "flax", "pytorch_distributed_tpu")
bad = sorted(m for m in sys.modules
             if m in banned or m.startswith(tuple(b + "." for b in banned)))
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
