"""The port's GPT-2 against the JAX package's flax GPT-2, on the CPU.

Weights are drawn by flax and copied into the port with
``gpt2_state_dict_from_flax`` (the two init RNGs differ). Uncached logits
and the slotted and paged cached prefill + decode logits must agree at
1e-4 (fp32; sums taken in another order). The 16-bit LM head
(``head_in_fp32=False``) is held in bf16, and its autograd Function
(``HeadMatmul``, the route on every device) against the widened fp32
autograd of the same product.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from pytorch_distributed_tpu.serving import KVCache as JaxKVCache
from pytorch_distributed_tpu.serving.paging import PagedKVCache as JaxPagedKVCache
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import HeadMatmul
from pytorch_distributed_tpu_torch.serving import KVCache, PagedKVCache

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(vocab_size=97, n_positions=48, n_embd=48, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **TINY))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    model = GPT2(GPT2Config(**TINY), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model.load_state_dict(gpt2_state_dict_from_flax(params))
    return jmodel, variables, model


def _logits(model, tokens, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(tokens), **kw)


def test_converted_state_dict_covers_every_parameter(models):
    _, variables, model = models
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    sd = gpt2_state_dict_from_flax(params)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # Dense [in, out] -> Linear [out, in]
    np.testing.assert_array_equal(
        sd["h.1.mlp.c_fc.weight"].numpy(),
        params["h_1"]["mlp"]["c_fc"]["kernel"].T)


def test_uncached_logits_match_flax(models):
    jmodel, variables, model = models
    tokens = np.random.default_rng(0).integers(0, 97, (2, 11))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(tokens)))
    got = _logits(model, tokens)
    assert got.dtype == torch.float32 and got.shape == (2, 11, 97)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _xent(logits, targets):
    """Mean token cross-entropy of fp32 logits, in numpy-free jax ops."""
    lse = jax.nn.logsumexp(logits, axis=-1)
    tgt = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(lse - tgt)


def test_bf16_head_logits_and_gradients_match_flax(models):
    """``head_in_fp32=False`` in a bf16 model (fp32 parameters): the head
    contracts bf16 hidden states with the bf16 copy of ``wte`` into fp32,
    on both sides. Logits, the loss's gradient against ``wte`` (head and
    embedding) and against the post-``ln_f`` hidden states. Tolerance
    2e-2 x (1 + |flax|), scaled to each tensor's largest element for the
    gradients: the two bf16 forwards round activations at other places
    (LayerNorm, attention, GELU), and a bf16 ulp is 2^-8 of the value."""
    _, variables, _ = models
    cfg = dict(TINY, head_in_fp32=False)
    jmodel = JaxGPT2(JaxGPT2Config(dtype=jnp.bfloat16, **cfg))
    model = GPT2(GPT2Config(dtype=torch.bfloat16, **cfg), device="cpu")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model.load_state_dict(gpt2_state_dict_from_flax(params))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 97, (2, 11))
    targets = rng.integers(0, 97, (2, 11))

    def jloss(p):
        return _xent(jmodel.apply({"params": p}, jnp.asarray(tokens)),
                     jnp.asarray(targets))

    jlogits = np.asarray(jmodel.apply(variables, jnp.asarray(tokens)))
    jgrads = jax.grad(jloss)(variables["params"])
    jhidden = jmodel.apply(variables, jnp.asarray(tokens), return_hidden=True)
    wte16 = variables["params"]["wte"].astype(jnp.bfloat16)
    jdh = jax.grad(lambda h: _xent(jnp.einsum(
        "btc,vc->btv", h, wte16, preferred_element_type=jnp.float32),
        jnp.asarray(targets)))(jhidden)

    tt, ty = torch.from_numpy(tokens), torch.from_numpy(targets).long()
    logits = model(tt)
    assert logits.dtype == torch.float32
    F_xent = torch.nn.functional.cross_entropy
    F_xent(logits.reshape(-1, 97), ty.reshape(-1)).backward()
    hidden = model(tt, return_hidden=True).detach().requires_grad_()
    assert hidden.dtype == torch.bfloat16
    dh, = torch.autograd.grad(
        F_xent(model._head(hidden).reshape(-1, 97), ty.reshape(-1)), hidden)

    def close(got, want):
        got = got.detach().float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_array_less(np.abs(got - want),
                                     2e-2 * (scale + np.abs(want)))

    close(logits, jlogits)
    close(model.wte.grad, jgrads["wte"])
    close(dh, jdh)


def test_head_function_matches_widened_autograd():
    """The autograd Function the 16-bit head runs through, on the CPU
    (where its product widens the operands): its forward and its
    backward (JAX's transpose: the fp32 cotangent against the widened
    operands, dx and dw rounded to bf16) against torch's own autograd of
    the widened product. The products are the same; the summation order of
    dw may differ, so one bf16 ulp (2^-8 of the value) apart at most."""
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16).requires_grad_() for s in ((12, 16), (40, 16)))
    g = torch.from_numpy(rng.standard_normal((12, 40)).astype(np.float32))
    got = HeadMatmul.apply(x, w)
    dx, dw = torch.autograd.grad(got, (x, w), g)
    want = torch.matmul(x.float(), w.float().t())
    wdx, wdw = torch.autograd.grad(want, (x, w), g)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (dx.dtype, dw.dtype) == (torch.bfloat16, torch.bfloat16)
    torch.testing.assert_close(dx, wdx, rtol=0, atol=0)
    torch.testing.assert_close(dw.float(), wdw.float(), rtol=2 ** -8,
                               atol=1e-6)


def _run_cached(jmodel, variables, model, jcache, cache, windows):
    """Feed each ``(tokens [B, T], offsets [B])`` window to both models;
    compare logits after every window."""
    for tokens, off in windows:
        want, jcache = jmodel.apply(
            variables, jnp.asarray(tokens), kv_cache=jcache,
            position_offset=jnp.asarray(off))
        got, cache = _logits(model, tokens, kv_cache=cache,
                             position_offset=torch.from_numpy(off))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return jcache, cache


def test_slotted_cached_prefill_and_decode_match_flax(models):
    jmodel, variables, model = models
    rng = np.random.default_rng(1)
    jcache = JaxKVCache.create(jmodel.cfg, n_slots=2, max_len=32)
    cache = KVCache.create(model.cfg, n_slots=2, max_len=32, device="cpu")
    windows = [(rng.integers(0, 97, (2, 8)), np.array([0, 0], np.int32))]
    windows += [(rng.integers(0, 97, (2, 1)), np.array([8 + i, 5 + i], np.int32))
                for i in range(3)]
    jcache, cache = _run_cached(jmodel, variables, model, jcache, cache,
                                windows)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)


def test_paged_cached_prefill_and_decode_match_flax(models):
    """Prefill, decode through the port's decode op, and a prefill window
    whose padded tail passes n_positions (the wpe clamp) and the block
    table (the trash-page route)."""
    jmodel, variables, model = models
    rng = np.random.default_rng(2)
    page, max_len = 4, 48
    tables = np.zeros((2, 12), np.int32)
    tables[0] = rng.permutation(np.arange(1, 13))
    tables[1, :5] = np.arange(13, 18)
    jcache = JaxPagedKVCache.create(jmodel.cfg, n_slots=2, max_len=max_len,
                                    page_size=page)
    jcache = jcache.replace(block_tables=jnp.asarray(tables))
    cache = PagedKVCache.create(model.cfg, n_slots=2, max_len=max_len,
                                page_size=page, device="cpu")
    cache.block_tables.copy_(torch.from_numpy(tables))
    windows = [(rng.integers(0, 97, (2, 8)), np.array([0, 0], np.int32))]
    windows += [(rng.integers(0, 97, (2, 1)), np.array([8 + i, 8 + i], np.int32))
                for i in range(3)]
    windows += [(rng.integers(0, 97, (2, 8)), np.array([44, 11], np.int32))]
    jcache, cache = _run_cached(jmodel, variables, model, jcache, cache,
                                windows)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
