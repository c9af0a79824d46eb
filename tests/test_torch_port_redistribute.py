"""The port's redistribution planner against the JAX planner, on the CPU.

``pytorch_distributed_tpu_torch.redistribute.plan`` is pure planning over
shapes, dtypes and placements, so the two planners are held leaf by leaf:
the same ``ops``, the same ``chunks`` and ``chunk_dim`` of every step and
the same ``TransferCost``. The JAX side plans on the conftest's 8 virtual
CPU devices, the port on stand-in meshes (``tests/_torch_port_tp.py``'s
``StubMesh``: sizes alone, ranks ``range(n)``) of the same shapes and rank
sets. The cases are ``tests/test_redistribute.py``'s fixed ones (the
classification, the peak formula, cross-mesh 8 -> (2, 2), host to mesh,
chunked staging under ``max_staging_bytes``, a tree with ``None``
entries), its four round trips both ways, and 20 seeded ``random_spec``
pairs over its ``MESHES``. The last test scans the port's modules for an
import of JAX or of the JAX package.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.redistribute import (
    OPS,
    Sharding,
    TransferCost,
    plan_transfer,
    plan_tree,
)
from tests._torch_port_tp import StubMesh

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DTYPES = {np.float32: torch.float32, np.int32: torch.int32,
          np.float16: torch.float16}


def jax_mesh(shape, axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def both(mesh_shape, axes, spec):
    """The JAX ``NamedSharding`` and the port's ``Sharding`` of one
    placement (``spec`` a tuple of PartitionSpec entries)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return (NamedSharding(jax_mesh(mesh_shape, axes), P(*spec)),
            Sharding(StubMesh(mesh_shape, axes), spec))


def assert_same_plan(theirs, ours):
    assert ours.ops == theirs.ops
    assert all(op in OPS for op in ours.ops)
    assert [(s.chunks, s.chunk_dim) for s in ours.steps] == \
        [(s.chunks, s.chunk_dim) for s in theirs.steps]
    assert (ours.cost.bytes_moved, ours.cost.peak_bytes,
            ours.cost.naive_gather_bytes) == (
        theirs.cost.bytes_moved, theirs.cost.peak_bytes,
        theirs.cost.naive_gather_bytes)
    assert tuple(ours.shape) == tuple(theirs.shape)


def plan_both(shape, dtype, src, dst, **kw):
    """``src``/``dst``: ``(mesh shape, axes, spec)`` or None (the host)."""
    from pytorch_distributed_tpu.redistribute import (
        plan_transfer as jax_plan_transfer,
    )

    js, ps = both(*src) if src is not None else (None, None)
    jd, pd = both(*dst)
    theirs = jax_plan_transfer(shape, dtype, js, jd, **kw)
    ours = plan_transfer(shape, DTYPES[dtype], ps, pd, **kw)
    assert_same_plan(theirs, ours)
    return ours


X8 = ((8,), ("x",))
DT = ((2, 4), ("dp", "tp"))


def test_all_to_all_beats_naive_strictly():
    plan = plan_both((16, 24), np.float32, (*X8, ("x", None)),
                     (*X8, (None, "x")))
    assert plan.ops == ("all_to_all",)
    assert plan.cost.peak_bytes < plan.cost.naive_gather_bytes
    assert 0 < plan.cost.bytes_moved < plan.cost.naive_gather_bytes


@pytest.mark.parametrize("src,dst,op", [
    (("x", None), (None, None), "all_gather"),
    ((None, None), ("x", None), "dynamic_slice"),
    (("x", None), (None, "x"), "all_to_all"),
    (("x", None), ("x", None), "noop"),
    (None, ("x", None), "device_put"),
], ids=["gather", "slice", "all_to_all", "noop", "host"])
def test_classification_covers_all_ops(src, dst, op):
    plan = plan_both((16, 24), np.float32,
                     (*X8, src) if src is not None else None, (*X8, dst))
    assert plan.ops == (op,)


def test_noop_costs_nothing():
    plan = plan_both((16,), np.float32, (*X8, ("x",)), (*X8, ("x",)))
    assert plan.ops == ("noop",) and plan.cost.bytes_moved == 0


def test_peak_formula_is_shard_sums():
    plan = plan_both((16, 24), np.float32, (*X8, ("x", None)),
                     (*X8, (None, "x")))
    total = 16 * 24 * 4
    assert plan.cost.peak_bytes == total // 8 + total // 8
    assert plan.cost.naive_gather_bytes == total // 8 + total


def test_plans_are_deterministic():
    args = ((16, 24), np.float32, (*DT, ("dp", "tp")),
            (*DT, (None, ("dp", "tp"))))
    assert plan_both(*args) == plan_both(*args)


def test_cross_mesh_and_host_to_mesh():
    plan = plan_both((16, 24), np.float32, (*X8, ("x", None)),
                     ((2, 2), ("a", "b"), ("a", "b")))
    assert plan.ops == ("device_put",)
    assert plan.cost.bytes_moved == 16 * 24 * 4 // 4
    plan = plan_both((16, 24), np.float32, None, (*DT, ("dp", "tp")))
    assert plan.ops == ("device_put",)


def test_chunked_staging_bounds_the_peak():
    dst_shard = 32 * (24 // 4) * 4
    plan = plan_both((32, 24), np.float32, None, (*DT, (None, "tp")),
                     max_staging_bytes=dst_shard // 4)
    (step,) = plan.steps
    assert step.chunks > 1 and step.chunk_dim == 0
    assert step.staging_bytes == dst_shard // 4
    unchunked = plan_both((32, 24), np.float32, None, (*DT, (None, "tp")))
    assert plan.cost.peak_bytes < unchunked.cost.peak_bytes
    # the reference's refused-in-jit case, and a budget below one row
    assert plan_both((32, 24), np.float32, None, (*DT, (None, "tp")),
                     max_staging_bytes=256).steps[0].chunks > 1
    plan_both((32, 24), np.float32, (*X8, ("x", None)),
              ((2, 2), ("a", "b"), (None, ("a", "b"))), max_staging_bytes=7)


def test_gpt2_c_proj_worked_example():
    """``mlp.c_proj.weight`` [768, 3072] fp32, dim 0 over 4 ranks to dim 1
    over the tp axis of a (1, 4) mesh of the same ranks: one all-to-all
    whose peak is half the naive gather's."""
    plan = plan_both((768, 3072), np.float32, ((4,), ("dp",), ("dp", None)),
                     ((1, 4), ("dp", "tp"), (None, "tp")))
    assert plan.ops == ("all_to_all",)
    assert plan.cost.peak_bytes == 4_718_592
    assert plan.cost.naive_gather_bytes == 11_796_480
    # the same dim on both meshes: the same boxes, nothing moves
    plan = plan_both((3072, 768), np.float32, ((4,), ("dp",), ("dp", None)),
                     ((1, 4), ("dp", "tp"), ("tp", None)))
    assert plan.ops == ("device_put",) and plan.cost.bytes_moved == 0


def test_tree_plan_none_entries_pass_through():
    import jax
    from pytorch_distributed_tpu.redistribute import plan_tree as jax_tree

    jdst, pdst = both(*X8, ("x", None))
    theirs = jax_tree(
        {"meta": jax.ShapeDtypeStruct((4,), np.float32),
         "w": jax.ShapeDtypeStruct((16, 24), np.float32)},
        {"w": jdst, "meta": None})
    ours = plan_tree(
        {"w": torch.empty(16, 24, device="meta"),
         "meta": torch.empty(4, device="meta")},
        {"w": pdst, "meta": None})
    assert len(ours.leaves) == len(theirs.leaves) == 2
    for t, o in zip(theirs.leaves, ours.leaves):
        assert o.ops == t.ops and o.cost == TransferCost(*(
            t.cost.bytes_moved, t.cost.peak_bytes, t.cost.naive_gather_bytes))
    assert ours.plans["meta"].steps == ()
    assert (ours.cost.bytes_moved, ours.cost.peak_bytes,
            ours.cost.naive_gather_bytes) == (
        theirs.cost.bytes_moved, theirs.cost.peak_bytes,
        theirs.cost.naive_gather_bytes)
    assert ours.cost == ours.cost + TransferCost(0, 0, 0)
    assert ours.cost.peak_bytes == max(p.cost.peak_bytes for p in ours.leaves)


MESHES = [
    ((8,), ("a",)),
    ((2, 4), ("a", "b")),
    ((4, 2), ("a", "b")),
    ((2, 2, 2), ("a", "b", "c")),
]


def random_spec(rng, axes, ndim):
    """``tests/test_redistribute.py``'s: each dim gets a disjoint subset of
    the axes."""
    pool = list(axes)
    rng.shuffle(pool)
    entries = []
    for _ in range(ndim):
        k = int(rng.integers(0, len(pool) + 1))
        take, pool = pool[:k], pool[k:]
        entries.append(tuple(take) if len(take) > 1
                       else (take[0] if take else None))
    return tuple(entries)


ROUND_TRIPS = [
    ((8,), ("a",), ("a", None), (8,), ("a",), (None, "a")),
    ((2, 4), ("a", "b"), ("a", "b"), (2, 4), ("a", "b"), ("b", "a")),
    ((8,), ("a",), (("a",), None), (2, 2, 2), ("a", "b", "c"),
     (("a", "b"), "c")),
    ((4, 2), ("a", "b"), (None, None), (2, 4), ("a", "b"), ("a", "b")),
]


@pytest.mark.parametrize("case", ROUND_TRIPS,
                         ids=["transpose", "swap-axes", "regroup-3d-mesh",
                              "slice-down"])
def test_round_trip_smoke_plans(case):
    sa, aa, spa, sb, ab, spb = case
    for dtype in (np.float32, np.float16):
        there = plan_both((16, 24), dtype, (sa, aa, spa), (sb, ab, spb))
        back = plan_both((16, 24), dtype, (sb, ab, spb), (sa, aa, spa))
        assert there.cost.peak_bytes <= there.cost.naive_gather_bytes
        assert back.cost.peak_bytes <= back.cost.naive_gather_bytes


@pytest.mark.parametrize("seed", range(20))
def test_random_spec_pairs(seed):
    rng = np.random.default_rng(seed)
    sa, aa = MESHES[int(rng.integers(0, len(MESHES)))]
    sb, ab = MESHES[int(rng.integers(0, len(MESHES)))]
    a = (sa, aa, random_spec(rng, aa, 2))
    b = (sb, ab, random_spec(rng, ab, 2))
    for kw in ({}, {"max_staging_bytes": 96}):
        there = plan_both((16, 24), np.float32, a, b, **kw)
        plan_both((16, 24), np.float32, b, a, **kw)
        plan_both((16, 24), np.float32, None, b, **kw)
        assert there.cost.peak_bytes <= there.cost.naive_gather_bytes or \
            there.ops == ("device_put",)


def test_from_placement_feeds_the_planner():
    """``{axis: dim}`` placements (TP's ``placement``, FSDP's rule) give
    the spec, each dim's axes in mesh order."""
    mesh = StubMesh((2, 4), ("fsdp", "tp"))
    s = Sharding.from_placement(mesh, {"tp": 0, "fsdp": 1}, 2)
    assert s.spec == (("tp",), ("fsdp",))
    assert Sharding.from_placement(mesh, {"tp": 1, "fsdp": 1}, 3).spec == \
        ((), ("fsdp", "tp"), ())
    assert Sharding.from_placement(mesh, {}, 2) == Sharding(mesh, ((), ()))
    assert Sharding(mesh, ("tp",)) != Sharding(mesh, ("tp", None))
    with pytest.raises(ValueError, match="not in mesh"):
        Sharding.from_placement(mesh, {"dp": 0}, 2)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, nor ``chip_smoke.py``, imports JAX or the
    JAX package (an AST scan of every import statement)."""
    files = sorted((REPO / "pytorch_distributed_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 50
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "orbax",
                       "pytorch_distributed_tpu"):
                bad.append((str(f.relative_to(REPO)), mod))
    assert not bad, bad


def test_fused_projection_windows_plan_from_boxes():
    """The port's extension: ``c_attn``'s q, k and v rows, each a window
    of a ``[3C, C]`` tensor held in FSDP row blocks, planned onto the tp
    blocks of its own ``[C, C]``: the op and the bytes a rank lacks are
    read off the boxes (here counted row by row)."""
    src = Sharding(StubMesh((4,), ("fsdp",)), ("fsdp", None))
    dst = Sharding(StubMesh((1, 4), ("dp", "tp")), ("tp", None))
    row = 8 * 4
    for j in range(3):
        plan = plan_transfer((8, 8), torch.float32, src, dst,
                             region=((24, 8), (8 * j, 0)))
        lack = max(sum(not 6 * r <= 8 * j + i < 6 * r + 6
                       for i in range(2 * r, 2 * r + 2)) * row
                   for r in range(4))
        held = max(len([i for i in range(8 * j, 8 * j + 8)
                        if 6 * r <= i < 6 * r + 6]) for r in range(4))
        assert plan.ops == ("all_to_all",)
        assert plan.region == ((24, 8), (8 * j, 0))
        assert plan.cost == TransferCost(lack, held * row + 2 * row,
                                         held * row + 8 * row)
