"""The port's mixture-of-experts layer against the JAX package's, on the CPU.

Mirrors ``tests/test_expert.py``: the dispatch masks (at most one token a
cell, slot-0 priority, capacity truncation) and ``MoEMLP`` (E = 1 against
its one dense MLP, k = 2 without double counting, the aux loss and
``expert_fraction``, group sizes, router and expert gradients). Every
case holds the port against the JAX function on the same inputs, made
from a seed with numpy, with flax's weights carried into the port:

* ``make_dispatch_masks``: bit for bit (each cell holds at most one
  assignment, so the masks are exact in any summation order);
* ``MoEMLP``: the routes first (``expert_idx`` equal to JAX's, a
  departure allowed only where the router's top-k gap is below 1e-6, and
  then counted: the streams' "top-2 gap" rule), then the output, the aux
  loss and ``expert_fraction`` at rtol 1e-5 of the largest reference
  value in fp32, and at 2e-2 with bf16 compute; every parameter's
  gradient against ``jax.grad`` at 1e-5 of its largest value.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pytorch_distributed_tpu.parallel.expert import MoEMLP as JaxMoEMLP
from pytorch_distributed_tpu.parallel.expert import (
    make_dispatch_masks as jax_masks,
)
from pytorch_distributed_tpu_torch.parallel import (
    ExpertParallel,
    MoEMLP,
    make_dispatch_masks,
)

torch.set_num_threads(2)

FP32_RTOL = 1e-5
BF16_RTOL = 2e-2
GAP = 1e-6


def _routing(rng, G, n, k, E):
    idx = rng.integers(0, E, (G, n, k)).astype(np.int32)
    if k > 1:   # distinct experts per token, as top_k gives
        idx[..., 1] = (idx[..., 0] + 1 + idx[..., 1] % (E - 1)) % E
    return idx, rng.random((G, n, k)).astype(np.float32)


def _both_masks(idx, gates, E, cap):
    jd, jc = jax_masks(jnp.asarray(idx), jnp.asarray(gates), E, cap)
    pd, pc = make_dispatch_masks(torch.from_numpy(idx).long(),
                                 torch.from_numpy(gates), E, cap)
    return (np.asarray(jd), np.asarray(jc)), (pd.numpy(), pc.numpy())


@pytest.mark.parametrize("G,n,k,E,cap", [(2, 16, 2, 4, 8), (1, 33, 1, 5, 4),
                                         (3, 24, 2, 8, 3), (1, 8, 2, 2, 1)])
def test_dispatch_masks_bit_for_bit(G, n, k, E, cap):
    idx, gates = _routing(np.random.default_rng(G * 100 + n), G, n, k, E)
    (jd, jc), (pd, pc) = _both_masks(idx, gates, E, cap)
    assert pd.dtype == np.float32 and pc.dtype == np.float32
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)
    # each (expert, position) cell holds at most one assignment
    assert pd.sum(axis=1).max() <= 1.0


def test_local_expert_columns_are_the_whole_masks_columns():
    idx, gates = _routing(np.random.default_rng(7), 2, 16, 2, 4)
    whole = make_dispatch_masks(torch.from_numpy(idx).long(),
                                torch.from_numpy(gates), 4, 6)
    for e0, e1 in ((0, 2), (2, 4), (1, 2)):
        part = make_dispatch_masks(torch.from_numpy(idx).long(),
                                   torch.from_numpy(gates), 4, 6,
                                   experts=(e0, e1))
        for w, p in zip(whole, part):
            assert torch.equal(w[:, :, e0:e1], p)


def test_slot0_priority_on_overflow():
    idx = np.zeros((1, 4, 2), np.int32)
    idx[..., 1] = 1
    gates = np.ones((1, 4, 2), np.float32)
    (jd, _), (pd, _) = _both_masks(idx, gates, 2, 1)
    np.testing.assert_array_equal(pd, jd)
    d = pd[0]
    assert d[0, 0, 0] == 1.0 and d[1:, 0, :].sum() == 0.0
    assert d[0, 1, 0] == 1.0


def test_capacity_truncation_drops_tokens():
    idx = np.zeros((1, 8, 1), np.int32)
    gates = np.ones((1, 8, 1), np.float32)
    (jd, _), (pd, _) = _both_masks(idx, gates, 2, 2)
    np.testing.assert_array_equal(pd, jd)
    assert pd.sum() == 2 and pd[0, :2, 0].sum() == 2


def test_dispatch_dtype():
    idx, gates = _routing(np.random.default_rng(3), 1, 8, 2, 4)
    d, c = make_dispatch_masks(torch.from_numpy(idx).long(),
                               torch.from_numpy(gates), 4, 4, torch.bfloat16)
    assert d.dtype == torch.bfloat16 and c.dtype == torch.float32


# -- MoEMLP -------------------------------------------------------------------
def _port_moe(params, C, dtype=torch.float32, **kw):
    E = params["experts_up"].shape[0]
    d_ff = params["experts_up"].shape[2]
    m = MoEMLP(E, d_ff, C, dtype=dtype, **kw)
    with torch.no_grad():
        m.router.weight.copy_(torch.tensor(
            np.asarray(params["router"]["kernel"]).T))
        m.router.bias.copy_(torch.tensor(np.asarray(params["router"]["bias"])))
        m.experts_up.copy_(torch.tensor(np.asarray(params["experts_up"])))
        m.experts_down.copy_(torch.tensor(np.asarray(params["experts_down"])))
    return m


def _pair(B, T, C, E, d_ff, seed, dtype=jnp.float32, **kw):
    x = np.random.default_rng(seed).standard_normal((B, T, C)).astype(
        np.float32)
    jm = JaxMoEMLP(n_experts=E, d_ff=d_ff, dtype=dtype, **kw)
    params = jm.init(jax.random.key(seed), jnp.asarray(x))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pm = _port_moe(params["params"], C, tdtype, **kw)
    return x, jm, params, pm


def _routes(x, params, k):
    """Per token: the port's route departs from JAX's (each departure
    allowed only at a top-k gap below ``GAP``)."""
    p = params["params"]["router"]
    jp = jax.nn.softmax(jnp.asarray(x) @ p["kernel"] + p["bias"], -1)
    _, jidx = jax.lax.top_k(jp, k)
    tp = torch.softmax(F.linear(torch.tensor(x), torch.tensor(
        np.asarray(p["kernel"]).T), torch.tensor(np.asarray(p["bias"]))), -1)
    top, tidx = torch.topk(tp, min(k + 1, tp.shape[-1]), dim=-1)
    differ = (tidx[..., :k].numpy() != np.asarray(jidx)).any(-1)
    gaps = (top[..., :-1] - top[..., 1:]).min(-1).values.numpy() \
        if top.shape[-1] > 1 else np.full(differ.shape, np.inf)
    assert (gaps[differ] < GAP).all(), "a route departs at a clear gap"
    return differ


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


CASES = {
    "k1": dict(B=2, T=8, C=16, E=4, d_ff=32, k=1, capacity_factor=1.25),
    "k2": dict(B=2, T=8, C=16, E=4, d_ff=32, k=2, capacity_factor=8.0),
    "group": dict(B=2, T=16, C=8, E=2, d_ff=16, k=1, capacity_factor=2.0,
                  group_size=8),
    "overflow": dict(B=2, T=16, C=8, E=4, d_ff=16, k=2, capacity_factor=0.5),
    "e1": dict(B=2, T=8, C=16, E=1, d_ff=32, k=1, capacity_factor=2.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(case, dtype):
    kw = dict(CASES[case])
    B, T, C, E, d_ff = (kw.pop(n) for n in ("B", "T", "C", "E", "d_ff"))
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, jm, params, pm = _pair(B, T, C, E, d_ff, seed=len(case), dtype=jdtype,
                              **kw)
    differ = _routes(x.reshape(-1, C), params, kw["k"])
    jout, jaux = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        pout, paux = pm(torch.tensor(x))
    assert pout.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    # a near-tie departure moves its whole routing group: those groups are
    # reported and left out of the output check, the aux terms too
    gsz = kw.get("group_size") or B * T
    flipped = differ.reshape(-1, gsz).any(-1)
    print(f"{case}/{dtype}: {int(differ.sum())} near-tie route departures")
    assert not flipped.all()
    keep = np.repeat(~flipped, gsz)
    rtol = FP32_RTOL if dtype == "float32" else BF16_RTOL
    _close(pout.float().numpy().reshape(-1, C)[keep],
           np.asarray(jout, np.float32).reshape(-1, C)[keep], rtol)
    if not flipped.any():
        _close(paux["aux_loss"].item(), jaux["aux_loss"], FP32_RTOL)
        np.testing.assert_array_equal(paux["expert_fraction"].numpy(),
                                      np.asarray(jaux["expert_fraction"]))
    if case == "overflow":   # 4 experts x 8 places for 32 x 2 claims
        assert pm.capacity(B * T) * E < B * T * kw["k"]


def test_e1_matches_its_dense_mlp():
    x, _, params, pm = _pair(2, 8, 16, 1, 32, seed=1, k=1,
                             capacity_factor=2.0)
    with torch.no_grad():
        out, _ = pm(torch.tensor(x))
    w_up = torch.tensor(np.asarray(params["params"]["experts_up"][0]))
    w_dn = torch.tensor(np.asarray(params["params"]["experts_down"][0]))
    dense = F.gelu(torch.tensor(x).reshape(-1, 16) @ w_up,
                   approximate="tanh") @ w_dn
    torch.testing.assert_close(out.reshape(-1, 16), dense, rtol=2e-5,
                               atol=2e-5)


def test_aux_near_one_and_fractions_sum_to_one():
    x, _, _, pm = _pair(4, 16, 8, 4, 16, seed=3, k=1, capacity_factor=4.0)
    _, aux = pm(torch.tensor(x))
    assert 0.9 < float(aux["aux_loss"]) < 1.3
    assert abs(float(aux["expert_fraction"].sum()) - 1.0) < 1e-5


def test_group_size_must_divide():
    m = MoEMLP(2, 16, 8, group_size=7)
    with pytest.raises(ValueError, match="must divide"):
        m(torch.zeros(2, 16, 8))


@pytest.mark.parametrize("k", [1, 2])
def test_every_gradient_matches_jax_grad(k):
    B, T, C, E, d_ff = 2, 8, 16, 4, 16
    x, jm, params, pm = _pair(B, T, C, E, d_ff, seed=5 + k, k=k,
                              capacity_factor=1.5)
    assert not _routes(x.reshape(-1, C), params, k).any()

    def loss(p, xx):
        out, aux = jm.apply(p, xx)
        return jnp.sum(out ** 2) + 0.01 * aux["aux_loss"]

    jg, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out, aux = pm(xt)
    ((out ** 2).sum() + 0.01 * aux["aux_loss"]).backward()
    g = jg["params"]
    pairs = {
        "router.weight": np.asarray(g["router"]["kernel"]).T,
        "router.bias": g["router"]["bias"],
        "experts_up": g["experts_up"],
        "experts_down": g["experts_down"],
    }
    for name, want in pairs.items():
        got = dict(pm.named_parameters())[name].grad
        assert float(got.abs().sum()) > 0, name
        _close(got.numpy(), want, FP32_RTOL)
    _close(xt.grad.numpy(), jgx, FP32_RTOL)


def test_init_follows_flax_lecun_normal_on_three_dims():
    torch.manual_seed(0)
    m = MoEMLP(8, 256, 64)
    m.reset_parameters(torch.Generator().manual_seed(0))
    # a truncated normal with variance 1 / (fan_in x E): flax counts the
    # leading E as a receptive field
    for w, fan_in in ((m.experts_up, 64 * 8), (m.experts_down, 256 * 8)):
        std = float(w.std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.02, (std, fan_in)
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert abs(float(m.router.weight.std()) * 8 - 1.0) < 0.05
    assert float(m.router.bias.abs().max()) == 0.0


def test_expert_parallel_style():
    s = ExpertParallel()
    assert s.shard_dim("h.1.moe.experts_up", (8, 16, 32)) == 0
    assert s.shard_dim("x", (8,)) == 0
    assert s.shard_dim("x", ()) is None
