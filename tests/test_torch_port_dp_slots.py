"""Slots on dp in the port's serving engine against the JAX package's, on
4 gloo ranks.

The ranks (``tests/_torch_port_ranks.py``; the body is this module's
``serve_body``, which imports no JAX) serve ``tests/_torch_port_tp.py``'s
five requests with the weights flax drew (GPT-2 with 2 layers, width 48,
4 heads, vocab 97) through one ``Scheduler`` each, over a slotted cache of
4 slots cut over dp (``kv_cache_sharding(mesh, dp_axis="dp")``) and heads
cut over tp, at ``(dp 2, tp 2)`` and ``(dp 4, tp 1)``, with ``spec_k`` 0
and 3 (a one-layer self-draft), and at ``(2, 2)`` with a separate
one-layer draft model (its own slotted cache, cut the same way). Held:

* every rank's greedy streams equal, token for token, the JAX
  ``Scheduler``'s on the unsharded engine, and the JAX ``Scheduler``'s
  with the same cache sharding on a ``(2, 2)`` mesh of 4 virtual CPU
  devices (the reference runs this path too);
* each rank holds exactly ``1 / (dp * tp)`` of the cache's bytes
  (``[L, S/dp, T, H/tp, D]`` for K and V), the draft model's cache too;
* a sampled run (temperature 1, one seed on every rank), with and without
  speculation, gives every rank the same streams of in-vocabulary tokens
  of the requested lengths: sampled streams are held by support and by
  the ranks' agreement, never token for token. Its first four requests
  share one prompt and fill slots 0-3, so slot 0 and slot 2 lie on
  different dp ranks: their streams must differ (each dp rank folds its
  rank into the seed; ranks drawing alike would give them the same
  tokens);
* the engine runs its bodies eagerly on gloo (``graphs`` False).
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp as tph

torch.set_num_threads(2)

MESHES = ((2, 2), (4, 1))
SPEC = (0, 3)
KW = dict(n_slots=4, max_len=40, prefill_len=16)
SAME_NEW = 10       # the sampled runs' four same-prompt requests' lengths


def sampled_requests():
    """Four requests of one prompt (slots 0-3), then the five others."""
    reqs = tph.serve_requests()
    return [(reqs[0][0], SAME_NEW)] * 4 + reqs


def _engine_kw(spec_k):
    return dict(KW, spec_k=spec_k, draft_layers=1) if spec_k else dict(KW)


def serve_body(rank, store_dir, state_dict):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        SamplingParams,
        Scheduler,
        kv_cache_sharding,
        serving_mesh,
        shard_gpt2_params,
    )

    def run(mesh, spec_k, sampling=SamplingParams(), draft=False,
            requests=tph.serve_requests()):
        model = GPT2(GPT2Config(**tph.SERVE), device="cpu")
        model.load_state_dict(state_dict)
        shard_gpt2_params(model, mesh)
        kw = _engine_kw(spec_k)
        if draft:
            d = GPT2(GPT2Config(**{**tph.SERVE, "n_layer": 1}), device="cpu",
                     seed=4)
            params = {k: v.clone() for k, v in d.state_dict().items()}
            shard_gpt2_params(d, mesh)
            kw.update(draft_layers=None, draft_model=d, draft_params=params)
        engine = InferenceEngine(
            model, device="cpu", sampling=sampling,
            seed=0,
            cache_sharding=kv_cache_sharding(mesh, dp_axis="dp"), **kw)
        sched = Scheduler(engine, emit_events=False)
        for prompt, n_new in requests:
            sched.submit(Request(prompt=prompt, max_new_tokens=n_new))
        streams = {f.request_id: list(f.tokens) for f in sched.run()}
        cache, dcache = sched.cache, sched.draft_cache
        return {"streams": streams, "graphs": engine.graphs,
                "own_slots": engine.own_slots,
                "cache_shape": tuple(cache.k.shape),
                "cache_bytes": cache.k.nbytes + cache.v.nbytes,
                "draft_shape": None if dcache is None else tuple(
                    dcache.k.shape)}

    out = {}
    for dp, tp in MESHES:
        mesh = serving_mesh(dp=dp, tp=tp)
        for spec_k in SPEC:
            out[(dp, tp, spec_k)] = run(mesh, spec_k)
    mesh = serving_mesh(dp=2, tp=2)
    out["draft"] = run(mesh, 3, draft=True)
    for spec_k in SPEC:
        out["sampled", spec_k] = run(mesh, spec_k,
                                     SamplingParams(temperature=1.0),
                                     requests=sampled_requests())
    torch.save(out, f"{store_dir}/dp_slots.rank{rank}.pt")


def jax_streams(variables):
    """The JAX Scheduler's greedy streams on the unsharded engine and on
    a (dp 2, tp 2) mesh with the slots on dp, for each spec_k."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
    from pytorch_distributed_tpu.serving.sharding import (
        gpt2_param_shardings,
        kv_cache_sharding,
        serving_mesh,
    )

    jmodel = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.SERVE))
    mesh = serving_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    shardings = gpt2_param_shardings(variables["params"], mesh)
    sharded = {"params": jax.tree_util.tree_map(
        jax.device_put, variables["params"], shardings)}
    out = {}
    for spec_k in SPEC:
        for tag, params, kw in (
                ("whole", variables, {}),
                ("dp2tp2", sharded, {"cache_sharding": kv_cache_sharding(
                    mesh, dp_axis="dp")})):
            sched = JaxScheduler(JaxEngine(jmodel, params, **kw,
                                           **_engine_kw(spec_k)),
                                 emit_events=False)
            for prompt, n_new in tph.serve_requests():
                sched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
            out[(tag, spec_k)] = {f.request_id: list(f.tokens)
                                  for f in sched.run()}
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    tmp = tmp_path_factory.mktemp("dp_slots")
    variables = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.SERVE)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    sd = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    ctx = ranks.start(serve_body, tmp, sd)
    want = jax_streams(variables)
    ranks.finish(ctx, timeout=180)
    got = [torch.load(tmp / f"dp_slots.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return got, want


def test_the_reference_serves_slots_on_dp(served):
    _, want = served
    for spec_k in SPEC:
        assert want[("dp2tp2", spec_k)] == want[("whole", spec_k)]


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("spec_k", SPEC)
def test_streams_equal_the_jax_schedulers(served, dp, tp, spec_k):
    got, want = served
    for rank, out in enumerate(got):
        r = out[(dp, tp, spec_k)]
        assert r["streams"] == want[("whole", spec_k)], rank
        assert not r["graphs"]


@pytest.mark.parametrize("dp,tp", MESHES)
def test_each_rank_holds_its_share_of_the_cache(served, dp, tp):
    got, _ = served
    cfg = tph.SERVE
    L, H, D = cfg["n_layer"], cfg["n_head"], cfg["n_embd"] // cfg["n_head"]
    whole = 2 * L * KW["n_slots"] * KW["max_len"] * H * D * 4   # K, V fp32
    per = KW["n_slots"] // dp
    for rank, out in enumerate(got):
        for spec_k in SPEC:
            r = out[(dp, tp, spec_k)]
            assert r["cache_shape"] == (L, per, KW["max_len"], H // tp, D)
            assert r["cache_bytes"] * dp * tp == whole
            first = (rank // tp) * per
            assert r["own_slots"] == range(first, first + per)


def test_separate_draft_model(served):
    """Greedy speculation emits the target's argmax whatever the draft:
    the streams of the unsharded JAX engine; the draft's cache holds the
    rank's slots and heads."""
    got, want = served
    cfg = tph.SERVE
    for out in got:
        r = out["draft"]
        assert r["streams"] == want[("whole", 3)]
        assert r["draft_shape"] == (1, KW["n_slots"] // 2, KW["max_len"],
                                    cfg["n_head"] // 2,
                                    cfg["n_embd"] // cfg["n_head"])


@pytest.mark.parametrize("spec_k", SPEC)
def test_sampled_streams_agree_across_ranks(served, spec_k):
    got, _ = served
    streams = [out["sampled", spec_k]["streams"] for out in got]
    assert all(s == streams[0] for s in streams)
    lengths = {i: n for i, (_, n) in enumerate(sampled_requests())}
    assert sorted(streams[0]) == sorted(lengths)
    for rid, toks in streams[0].items():
        assert len(toks) == lengths[rid]
        assert all(0 <= t < tph.SERVE["vocab_size"] for t in toks)
    # one prompt in slot 0 (dp rank 0) and slot 2 (dp rank 1): each dp
    # rank draws its own noise
    per = KW["n_slots"] // 2
    assert streams[0][0] != streams[0][per]
