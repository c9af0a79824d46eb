"""The port's mesh-axis collectives (``ops/collectives.py``) on 4 gloo
ranks against the JAX package's ``ops`` in ``shard_map`` over 4 CPU
devices, on the same per-rank inputs (``tests/test_collectives.py``'s
cases, with seeded random values where that file uses ranges).

Each rank's output equals the JAX device's of the same coordinate: sums
and maxima of four fp32 values in both, compared at 1e-6 (the sum order of
gloo and XLA may differ); gathers, scatters, permutes and all-to-alls bit
for bit. A 2 x 2 mesh holds the sub-axis and tuple-of-axes forms. The
collectives run through ``parallel.comm``: the counts and the bytes of an
all-reduce and a ring shift are checked too. JAX is imported inside the
tests only.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_comm as rb
from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

WS = rb.WS


def _inputs():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal((WS,) + shape).astype(np.float32)

    neg = np.array([[-2.0, 3.0], [1.0, -1.0], [2.0, 1.0], [0.5, -4.0]],
                   np.float32)
    return {"x": f32(3), "neg": neg, "rows": f32(2, 3), "square": f32(4, 4),
            "a2a": f32(2, 8), "a2a_u": f32(4, 3)}


def _jax_outputs(xs):
    import jax
    from jax.sharding import PartitionSpec as P

    import pytorch_distributed_tpu.ops as ops
    from pytorch_distributed_tpu.mesh import init_device_mesh

    devices = jax.devices()[:WS]
    mesh = init_device_mesh((WS,), ("dp",), devices=devices)
    mesh22 = init_device_mesh((2, 2), ("a", "b"), devices=devices)

    def per_rank(fn, x, m=mesh, spec=P("dp")):
        return np.asarray(ops.shard_map(lambda v: fn(v[0])[None], m,
                                        in_specs=(spec,), out_specs=spec)(x))

    def sub(fn):
        x = xs["x"].reshape(2, 2, 3)
        return per_rank(lambda v: fn(v[0])[None], x, mesh22,
                        P("a", "b")).reshape(WS, 3)

    ring = [(i, (i + 1) % WS) for i in range(WS)]
    return {
        "all_reduce_sum": per_rank(lambda v: ops.all_reduce(v, "dp"),
                                   xs["x"]),
        "all_reduce_ops": {op: per_rank(
            lambda v, op=op: ops.all_reduce(v, "dp", op=op), xs["x"])
            for op in ("mean", "max", "min")},
        "all_reduce_prod": per_rank(
            lambda v: ops.all_reduce(v, "dp", op="prod"), xs["neg"]),
        "all_gather": per_rank(lambda v: ops.all_gather(v, "dp"),
                               xs["rows"]),
        "all_gather_dim1": per_rank(
            lambda v: ops.all_gather(v, "dp", gather_dim=1), xs["rows"]),
        "all_gather_stacked": per_rank(
            lambda v: ops.all_gather(v, "dp", tiled=False), xs["rows"]),
        "reduce_scatter": per_rank(lambda v: ops.reduce_scatter(v, "dp"),
                                   xs["square"]),
        "reduce_scatter_mean_dim1": per_rank(
            lambda v: ops.reduce_scatter(v, "dp", op="mean", scatter_dim=1),
            xs["square"]),
        "broadcast": per_rank(lambda v: ops.broadcast(v, "dp", src=2),
                              xs["x"]),
        "all_to_all": per_rank(
            lambda v: ops.all_to_all(v, "dp", split_dim=1, concat_dim=0),
            xs["a2a"]),
        "all_to_all_untiled": per_rank(
            lambda v: ops.all_to_all(v, "dp", split_dim=0, concat_dim=1,
                                     tiled=False), xs["a2a_u"]),
        "permute_ring": per_rank(lambda v: ops.permute(v, "dp", ring),
                                 xs["x"]),
        "permute_partial": per_rank(lambda v: ops.permute(v, "dp", [(0, 2)]),
                                    xs["x"]),
        "send_to": per_rank(lambda v: ops.send_to(v, "dp", dst_offset=1),
                            xs["x"]),
        "recv_from": per_rank(lambda v: ops.recv_from(v, "dp", src_offset=1),
                              xs["x"]),
        "barrier": per_rank(lambda v: ops.barrier("dp"), xs["x"]),
        "axis_index_size": per_rank(
            lambda v: ops.axis_index("dp") * 100 + ops.axis_size("dp"),
            xs["x"]),
        "submesh": (sub(lambda v: ops.all_reduce(v, "b")),
                    sub(lambda v: ops.all_reduce(v, ("a", "b")))),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    xs = _inputs()
    store = tmp_path_factory.mktemp("collectives")
    ctx = ranks.start(rb.collectives_rank, store, xs)
    try:
        want = _jax_outputs(xs)
    finally:
        ranks.finish(ctx)
    return rb.load(store, "collectives"), want


EXACT = ("all_gather", "all_gather_dim1", "all_gather_stacked", "broadcast",
         "all_to_all", "all_to_all_untiled", "permute_ring",
         "permute_partial", "send_to", "recv_from")
SUMS = ("all_reduce_sum", "all_reduce_prod", "reduce_scatter",
        "reduce_scatter_mean_dim1")


@pytest.mark.parametrize("case", EXACT)
def test_data_movement_matches_jax_bit_for_bit(runs, case):
    got, want = runs
    for r in range(WS):
        np.testing.assert_array_equal(got[r][case].numpy(), want[case][r])


@pytest.mark.parametrize("case", SUMS)
def test_reductions_match_jax(runs, case):
    got, want = runs
    for r in range(WS):
        np.testing.assert_allclose(got[r][case].numpy(), want[case][r],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["mean", "max", "min"])
def test_all_reduce_ops_match_jax(runs, op):
    got, want = runs
    for r in range(WS):
        np.testing.assert_allclose(got[r]["all_reduce_ops"][op].numpy(),
                                   want["all_reduce_ops"][op][r],
                                   rtol=1e-6, atol=1e-6)


def test_axis_index_size_and_barrier(runs):
    got, want = runs
    for r in range(WS):
        index, size = got[r]["axis_index_size"]
        assert index * 100 + size == want["axis_index_size"][r]
        assert int(got[r]["barrier"]) == int(want["barrier"][r]) == 0


def test_submesh_axis_and_tuple_of_axes(runs):
    got, want = runs
    for r in range(WS):
        along_b, along_both, index_b, size_a = got[r]["submesh"]
        np.testing.assert_allclose(along_b.numpy(), want["submesh"][0][r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(along_both.numpy(), want["submesh"][1][r],
                                   rtol=1e-6, atol=1e-6)
        assert (index_b, size_a) == (r % 2, 2)


def test_collectives_are_counted_with_bytes(runs):
    got, _ = runs
    for out in got:
        counts, wire = out["counts"]
        assert counts["barrier"] == 1 and counts["all_reduce"] == 1
        assert counts["send"] == counts["recv"] == 1
        assert wire == {"all_reduce.float32": 12, "send.float32": 12}
