"""The port's placement rules against the JAX package's, with no ranks.

* ``shard_spec_with_reason`` gives the reference's dim and reason on a
  grid of shapes, axis sizes (1, 2, 4, 8) and min sizes (0, 8, 1024) that
  holds every case of ``tests/test_sharded_update.py``'s
  ``TestShardSpecReasons``.
* Applied to torch shapes (a ``Linear`` weight is flax's kernel
  transposed), the rule shards the same logical dim as the reference's on
  flax shapes, except where two dims tie (a square projection), where it
  can pick the other one; the bytes held are the same (ROADMAP C).
* Memory: at 8 shards, the port's per-rank optimizer-state bytes under
  ZeRO1 (``make_state_specs``) are within [1/8, 1.25/8] of DataParallel's,
  for ResNet-18 with SGD momentum (the reference's own probe,
  ``perf/memory_probe.py``, gives the same ratio) and for GPT-2 125M with
  AdamW; FSDP holds 1/8 of the parameter bytes within the same band; the
  fallback reasons count as the probe's ``_fallback_counts`` does for the
  same model.
* The strategies' flags, batch axes and ``collective_signature()`` are the
  reference's; ``ZeRO1(sharded_update=False)`` gathers its updated blocks,
  where the reference's compiled step has no parameter gather (ROADMAP C).

A mesh stand-in (axis names and sizes, no process groups) builds the
strategies, as the probe's ``SpecMesh`` does for the JAX ones.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.parallel import (
    DataParallel as JaxDP,
)
from pytorch_distributed_tpu.parallel import (
    FullyShardedDataParallel as JaxFSDP,
)
from pytorch_distributed_tpu.parallel import HybridShard as JaxHybrid
from pytorch_distributed_tpu.parallel import NoShard as JaxNoShard
from pytorch_distributed_tpu.parallel import ZeRO1 as JaxZeRO1
from pytorch_distributed_tpu.parallel import (
    shard_spec_with_reason as jax_rule,
)
from pytorch_distributed_tpu_torch.models import (
    GPT2,
    GPT2Config,
    gpt2_125m,
    resnet18,
)
from pytorch_distributed_tpu_torch.parallel import (
    SHARD_REASONS,
    DataParallel,
    FullyShardedDataParallel,
    HybridShard,
    NoShard,
    ZeRO1,
    make_state_specs,
    shard_spec_with_reason,
)
from pytorch_distributed_tpu_torch.parallel import sharded_update
from tests import _torch_port_sharding as sh

torch.set_num_threads(2)


class StubMesh:
    """Axis names and sizes, coordinate 0 on every axis, no groups."""

    def __init__(self, **axes):
        self._axes = dict(axes)
        self.device = torch.device("cpu")

    @property
    def axis_names(self):
        return tuple(self._axes)

    def size(self, axis):
        axes = (axis,) if isinstance(axis, str) else axis
        return math.prod(self._axes[a] for a in axes)

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def _probe():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "perf", "memory_probe.py")
    spec = importlib.util.spec_from_file_location("memory_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_dim(spec, axis):
    entries = tuple(spec)
    return entries.index(axis) if axis in entries else None


SHAPES = [(), (0, 3), (7,), (7, 9), (8, 8), (16, 64), (64, 64), (64, 16),
          (50257, 768), (768,), (3, 3, 64, 64), (64, 64, 3, 3), (1024, 3072),
          (3072, 1024), (8,), (4,), (2, 4, 6), (10,), (6, 12, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rule_equals_the_reference(shape):
    for size in (1, 2, 4, 8):
        for min_size in (0, 8, 1024):
            spec, reason = jax_rule(shape, "dp", size, min_size)
            got = shard_spec_with_reason(shape, "dp", size, min_size)
            assert got == (_jax_dim(spec, "dp"), reason), (size, min_size)
            assert reason in SHARD_REASONS


def test_reference_rule_cases():
    """``TestShardSpecReasons``, case by case."""
    assert shard_spec_with_reason((), "dp", 8, 0) == (None, "scalar")
    assert shard_spec_with_reason((64, 64), "dp", 1, 0) == (
        None, "trivial_axis")
    assert shard_spec_with_reason((8, 8), "dp", 8, 1024) == (None, "small")
    assert shard_spec_with_reason((7, 9), "dp", 8, 0) == (
        None, "indivisible")
    assert shard_spec_with_reason((0, 3), "dp", 8, 0) == (
        None, "indivisible")
    assert shard_spec_with_reason((16, 64), "dp", 8, 0) == (1, "sharded")
    assert shard_spec_with_reason((64, 64), "dp", 8, 0) == (0, "sharded")
    assert shard_spec_with_reason((7,), "dp", 8, 1024) == (None, "small")


def _jax_gpt2_shapes(**cfg):
    from pytorch_distributed_tpu.models import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models import GPT2Config as JaxCfg

    model = JaxGPT2(JaxCfg(**cfg))
    tokens = jnp.zeros((1, 8), jnp.int32)
    return jax.eval_shape(model.init, jax.random.key(0), tokens)["params"]


def test_torch_shapes_shard_the_same_logical_dim_but_ties():
    """The rule on torch shapes against the rule on flax shapes, through
    the conversion's transposes: the same logical dim wherever the largest
    divisible dim is unique; a square kernel ties, and the port picks its
    dim 0 (flax's out) where the reference picks flax's dim 0 (in)."""
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    flax = _jax_gpt2_shapes(**sh.GPT2_TINY)
    flat = {jax.tree_util.keystr(p): x.shape for p, x in
            jax.tree_util.tree_flatten_with_path(flax)[0]}
    as_torch = gpt2_state_dict_from_flax(jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), flax))
    model = GPT2(GPT2Config(**sh.GPT2_TINY), device="cpu")
    ties = 0
    for name, p in model.named_parameters():
        assert tuple(as_torch[name].shape) == tuple(p.shape)
        dim, reason = shard_spec_with_reason(tuple(p.shape), "dp", 4, 8)
        path = "".join(f"['{k}']" for k in _flax_path(name))
        fspec, freason = jax_rule(flat[path], "dp", 4, 8)
        fdim = _jax_dim(fspec, "dp")
        assert reason == freason, name
        transposed = p.dim() == 2 and name.endswith(".weight") and "h." in name
        logical = None if fdim is None else (1 - fdim if transposed else fdim)
        if dim != logical:
            assert p.shape[0] == p.shape[1], name   # only a tie
            ties += 1
    assert ties == sh.GPT2_TINY["n_layer"]          # each attn.c_proj


def _flax_path(name):
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h_{parts[1]}"] + parts[2:]
    leaf = {"weight": "scale" if "ln" in name else "kernel"}.get(
        parts[-1], parts[-1])
    return parts[:-1] + [leaf]


def _opt_bytes(model, opt, strategy, axis_size):
    specs = make_state_specs(model, opt, strategy)["opt_state"]
    params = dict(model.named_parameters())
    total = 0
    for name, state in specs.items():
        p = params[name]
        for key, dim in state.items():
            numel = 1 if key == "step" else p.numel()
            total += (numel // axis_size if dim is not None else numel) * 4
    return total


def _param_bytes(model, strategy, axis_size):
    dims = sharded_update.param_pspecs(strategy, model)
    return sum(p.numel() * 4 // (axis_size if dims[n] is not None else 1)
               for n, p in model.named_parameters())


@pytest.mark.parametrize("model_name", ["resnet18", "gpt2_125m"])
def test_memory_at_eight_shards(model_name):
    probe = _probe()
    mesh = StubMesh(dp=8)
    fmesh = StubMesh(fsdp=8)
    if model_name == "resnet18":
        model = resnet18(1000, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        flax_shapes = probe._build_shapes("resnet18", "sgd_momentum").params
        min_size = 1024
    else:
        model = gpt2_125m(device="cpu")
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
        flax_shapes = _jax_gpt2_shapes()
        min_size = 8
    dp_bytes = _opt_bytes(model, opt, DataParallel(mesh), 8)
    zero = ZeRO1(mesh, min_shard_size=min_size)
    ratio = _opt_bytes(model, opt, zero, 8) / dp_bytes
    assert 1 / 8 <= ratio <= 1.25 / 8, ratio
    fsdp = FullyShardedDataParallel(fmesh, min_shard_size=min_size)
    full = _param_bytes(model, NoShard("cpu"), 8)
    p_ratio = _param_bytes(model, fsdp, 8) / full
    assert 1 / 8 <= p_ratio <= 1.25 / 8, p_ratio
    if model_name == "resnet18":
        rows = probe.probe(model="resnet18", dp=8)["bytes_per_chip"]
        assert abs(ratio - rows["zero1_update"]["opt_ratio_vs_dp"]) < 1e-3
    # the fallback reasons, counted over the parameters
    for port, ref in ((zero, JaxZeRO1(probe.SpecMesh(dp=8),
                                       min_shard_size=min_size)),
                      (fsdp, JaxFSDP(probe.SpecMesh(fsdp=8),
                                     min_shard_size=min_size))):
        axis = getattr(port, "dp_axis", None) or port.fsdp_axis
        counts = {}
        for p in model.parameters():
            reason = shard_spec_with_reason(tuple(p.shape), axis, 8,
                                            min_size)[1]
            counts[reason] = counts.get(reason, 0) + 1
        assert counts == probe._fallback_counts(ref, flax_shapes)


def test_flags_axes_and_signatures():
    mesh, fmesh = StubMesh(dp=8), StubMesh(fsdp=8)
    hmesh = StubMesh(dcn=2, fsdp=4)
    dmesh = StubMesh(dp=2, fsdp=4)
    probe = _probe()
    jmesh, jfmesh = probe.SpecMesh(dp=8), probe.SpecMesh(fsdp=8)
    pairs = [
        (NoShard("cpu"), JaxNoShard(jmesh)),
        (DataParallel(mesh), JaxDP(jmesh)),
        (ZeRO1(mesh), JaxZeRO1(jmesh)),
        (FullyShardedDataParallel(fmesh), JaxFSDP(jfmesh)),
        (FullyShardedDataParallel(dmesh, dp_axis="dp"),
         JaxFSDP(probe.SpecMesh(dp=2, fsdp=4), dp_axis="dp")),
        (HybridShard(hmesh), JaxHybrid(probe.SpecMesh(dcn=2, fsdp=4))),
    ]
    for port, ref in pairs:
        assert port.sharded_update == ref.sharded_update, port
        assert port.batch_axes == ref.batch_axes, port
        assert port.data_shard_count == ref.data_shard_count, port
        assert port.collective_signature() == ref.collective_signature()
    port = ZeRO1(mesh, sharded_update=False)
    ref = JaxZeRO1(jmesh, sharded_update=False)
    assert port.sharded_update is ref.sharded_update is False
    assert ref.collective_signature()["param_gather"] == "none"
    assert port.collective_signature()["param_gather"] == "delta"
    # the placement answers: a dim where the reference has a spec
    for shape in [(64, 64), (10, 64), (7,)]:
        for port, ref in pairs[2:]:
            for method in ("param_pspec", "opt_pspec", "update_pspec",
                           "model_state_pspec"):
                spec = getattr(ref, method)("x", shape)
                axis = next((a for a in tuple(spec) if a), None)
                want = None if axis is None else tuple(spec).index(axis)
                assert getattr(port, method)("x", shape) == want, (
                    port, method, shape)


def test_make_state_specs_follows_the_parameter():
    """Adam's moments follow their parameter's opt_pspec; the step counts
    and the buffers stay whole."""
    model = GPT2(GPT2Config(**sh.GPT2_TINY), device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    strategy = ZeRO1(StubMesh(dp=4), min_shard_size=8)
    specs = make_state_specs(model, opt, strategy)
    for name, p in model.named_parameters():
        dim = strategy.opt_pspec(name, tuple(p.shape))
        assert specs["opt_state"][name] == {"step": None, "exp_avg": dim,
                                            "exp_avg_sq": dim}, name
        assert specs["params"][name] is None                # ZeRO1
    assert specs["opt_state"]["wte"]["exp_avg"] == 0        # [256, 64]
    fsdp = FullyShardedDataParallel(StubMesh(fsdp=4), min_shard_size=8)
    specs = make_state_specs(model, opt, fsdp)
    assert specs["params"]["wte"] == 0
    assert specs["params"]["h.0.mlp.c_fc.weight"] == 0     # [256, 64]
    assert all(d is None for d in specs["model_state"].values())
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    specs = make_state_specs(model, sgd, fsdp)
    assert specs["opt_state"]["wte"] == {"momentum_buffer": 0}
