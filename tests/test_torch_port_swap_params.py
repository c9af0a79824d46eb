"""Live weight swaps (``swap_params``) in the port, on the CPU.

The port copies new weights into the engine's parameters in place; the JAX
engine redistributes them onto the current placement. Both must leave a
greedy stream untouched when the values are equal (the reference's
``test_mid_stream_swap_keeps_greedy_parity``), and a swap to other weights
at one step must give the JAX scheduler's streams under the same swap.
"""

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
    Request,
    Scheduler,
)

torch.set_num_threads(2)

TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)
DRAFT = dict(vocab_size=97, n_positions=48, n_embd=24, n_layer=1, n_head=2)


def _flax(shape, seed):
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **shape))
    return jmodel, jmodel.init(jax.random.key(seed),
                               jnp.zeros((1, 8), jnp.int32))


def _state(variables):
    return gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))


def _model(shape, variables):
    model = GPT2(GPT2Config(**shape), device="cpu")
    model.load_state_dict(_state(variables))
    return model


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables = _flax(TINY, 0)
    _, other = _flax(TINY, 5)
    return jmodel, variables, other


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 97, size=5).astype(np.int32) for _ in range(2)]


def _oracle(model, prompt, n):
    seq = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(n):
            seq.append(int(torch.argmax(model(torch.tensor([seq]))[0, -1])))
    return seq[len(prompt):]


def test_swap_params_validates_structure_and_leaves(tiny):
    _, variables, _ = tiny
    engine = InferenceEngine(_model(TINY, variables), n_slots=1, max_len=16,
                             prefill_len=8, device="cpu")
    state = _state(variables)
    with pytest.raises(ValueError, match="structure"):
        engine.swap_params({})
    with pytest.raises(ValueError, match="structure"):
        engine.swap_params({**state, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaf mismatch"):
        engine.swap_params({**state, "wte": state["wte"][:, :1]})
    with pytest.raises(ValueError, match="leaf mismatch"):
        engine.swap_params({**state, "wte": state["wte"].double()})
    with pytest.raises(ValueError, match="draft"):
        engine.swap_params(state, draft_params=state)


def test_swap_params_copies_in_place(tiny):
    """Every parameter keeps its storage (a later CUDA-graph capture reads
    the same addresses) and takes the new values; numpy values work too."""
    _, variables, other = tiny
    model = _model(TINY, variables)
    engine = InferenceEngine(model, n_slots=1, max_len=16, prefill_len=8,
                             device="cpu")
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    new = {n: v.numpy() for n, v in _state(other).items()}
    cost = engine.swap_params(new)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert cost.bytes_moved == n_bytes > 0
    for name, p in model.named_parameters():
        assert p.data_ptr() == ptrs[name], name
        np.testing.assert_array_equal(p.detach().numpy(), new[name])
        assert p.requires_grad


def test_mid_stream_swap_keeps_greedy_parity(tiny):
    """Swap a value-identical state dict (other tensors, equal values) into
    a running scheduler between decode steps: every stream still equals
    the uncached-forward oracle, and the swap is counted and recorded."""
    _, variables, _ = tiny
    model = _model(TINY, variables)
    sched = Scheduler(InferenceEngine(model, n_slots=2, max_len=48,
                                      prefill_len=8, device="cpu"))
    prompts = _prompts()
    oracles = [_oracle(model, p, 12) for p in prompts]
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=12))
    for _ in range(4):
        sched.step()
    before = get_metrics().get("serving.weight_swaps", 0.0)
    cost = sched.swap_params({n: v.clone() for n, v in
                              model.state_dict().items()})
    assert cost.bytes_moved > 0
    assert sched.weight_swaps == 1
    assert sched.stats()["weight_swaps"] == 1.0
    assert get_metrics()["serving.weight_swaps"] == before + 1
    (ev,) = [e for e in recent_events(20) if e.name == "serving.weight_swap"]
    assert ev.metadata["bytes_moved"] == cost.bytes_moved
    assert ev.metadata["n_active"] == 2
    finished = sched.run()
    assert {f.request_id: f.tokens for f in finished} == dict(enumerate(oracles))


@pytest.mark.parametrize("cache_kind,spec", [("slotted", False),
                                             ("paged", False),
                                             ("paged", True)])
def test_mid_stream_swap_to_other_weights_matches_jax(tiny, cache_kind, spec):
    """Both schedulers swap to other weights after the same step: the
    port's streams equal the JAX scheduler's (plain and speculative)."""
    jmodel, variables, other = tiny
    kw = dict(n_slots=2, max_len=32, prefill_len=8, cache_kind=cache_kind)
    if cache_kind == "paged":
        kw["page_size"] = 4
    if spec:
        kw.update(spec_k=2, draft_layers=1)
    jsched = JaxScheduler(JaxEngine(jmodel, variables, **kw),
                          emit_events=False)
    sched = Scheduler(InferenceEngine(_model(TINY, variables), device="cpu",
                                      **kw), emit_events=False)
    for p in _prompts():
        jsched.submit(JaxRequest(prompt=p, max_new_tokens=12))
        sched.submit(Request(prompt=p, max_new_tokens=12))
    for _ in range(3):
        jsched.step()
        sched.step()
    jsched.swap_params(other)
    sched.swap_params(_state(other))
    want = {f.request_id: f.tokens for f in jsched.run()}
    got = {f.request_id: f.tokens for f in sched.run()}
    assert got == want


def test_draft_params_swap_on_a_draft_model_engine(tiny):
    """``draft_params`` goes into the separate draft model in place: the
    greedy streams stay the target's, and the accept counts after the swap
    are the JAX engine's after the same swap."""
    jmodel, variables, _ = tiny
    jdraft, dvars = _flax(DRAFT, 1)
    _, dother = _flax(DRAFT, 7)
    kw = dict(n_slots=2, max_len=32, prefill_len=8, spec_k=2)
    jsched = JaxScheduler(JaxEngine(jmodel, variables, draft_model=jdraft,
                                    draft_params=dvars, **kw),
                          emit_events=False)
    model = _model(TINY, variables)
    dmodel = GPT2(GPT2Config(**DRAFT), device="cpu")
    sched = Scheduler(InferenceEngine(model, draft_model=dmodel,
                                      draft_params=_state(dvars),
                                      device="cpu", **kw), emit_events=False)
    ptrs = [p.data_ptr() for p in dmodel.parameters()]
    prompts = _prompts()
    for p in prompts:
        jsched.submit(JaxRequest(prompt=p, max_new_tokens=12))
        sched.submit(Request(prompt=p, max_new_tokens=12))
    for _ in range(2):
        jsched.step()
        sched.step()
    jsched.swap_params(variables, draft_params=dother)
    sched.swap_params(_state(variables), draft_params=_state(dother))
    assert [p.data_ptr() for p in dmodel.parameters()] == ptrs
    for name, p in dmodel.state_dict().items():
        assert torch.equal(p, _state(dother)[name]), name
    want = {f.request_id: f.tokens for f in jsched.run()}
    got = {f.request_id: f.tokens for f in sched.run()}
    assert got == want == {i: _oracle(model, p, 12)
                           for i, p in enumerate(prompts)}
    assert sched.accept_rate.num == jsched.accept_rate.num
    assert sched.accept_rate.den == jsched.accept_rate.den
