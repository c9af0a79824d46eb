"""The port's context parallelism on 4 gloo ranks against the JAX package.

Each test spawns 4 CPU ranks (``torch.multiprocessing``, spawn, a FileStore
in the test's temporary directory) that run the port's ring or Ulysses
attention over a ``cp`` mesh, while the test computes the JAX package's
own on a 4-device ``cp`` mesh (Pallas in interpret mode). Every rank holds
the global ``[B, T, H, D]`` tensors whole, as the JAX wrappers'
``shard_map`` does, so the ranks' outputs and gradients must be equal, and
equal to JAX's. Tolerances are the JAX test's own
(``tests/test_context_parallel.py``): 2e-5 for outputs, 5e-5 for the
gradients of ``sum(out**2)`` (fp32).

JAX is imported inside the tests only: the ranks re-import this module.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks

torch.set_num_threads(2)

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
N = ranks.WORLD
B, T, H, D = 2, 32, 4, 8
RING_CASES = {  # name: (impl, causal, zigzag)
    "flash_causal": ("flash", True, False),
    "flash_full": ("flash", False, False),
    "flash_zigzag": ("flash", True, True),
    "einsum_causal": ("einsum", True, False),
    "einsum_zigzag": ("einsum", True, True),
}
ULYSSES_CASES = {  # name: (impl, causal)
    "flash_causal": ("flash", True),
    "flash_full": ("flash", False),
    "einsum_causal": ("einsum", True),
}


def _qkv(heads=H, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, heads, D)).astype(np.float32)
            for _ in range(3)]


def _run_port(attn, q, k, v):
    """out and the gradients of sum(out**2), all as numpy."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn(tq, tk, tv)
    (out ** 2).sum().backward()
    return [x.detach().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


def _run_jax(attn, q, k, v):
    import jax
    import jax.numpy as jnp

    def loss(*a):
        out = attn(*a)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*(jnp.asarray(x)
                                                  for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *grads)]


def _jax_mesh():
    import jax

    from pytorch_distributed_tpu.mesh import init_device_mesh

    return init_device_mesh((N,), ("cp",), devices=jax.devices()[:N])


def _load(store_dir):
    return [torch.load(store_dir / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _assert_ranks_agree_with(results, want, name):
    """Every rank's out and gradients equal rank 0's, and JAX's."""
    for r, got in enumerate(results):
        for a, b in zip(got, results[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: rank {r}")
    for label, a, b, tol in zip(("out", "dq", "dk", "dv"), results[0], want,
                                (OUT_TOL,) + (GRAD_TOL,) * 3):
        np.testing.assert_allclose(a, b, **tol, err_msg=f"{name}: {label}")


# -- rank bodies (run in the spawned processes) ----------------------------
def _ring_rank(rank, store_dir, inputs):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        make_ring_attention,
        zigzag_reorder,
    )

    mesh = init_device_mesh((N,), ("cp",))
    out = {}
    for name, (impl, causal, zigzag) in RING_CASES.items():
        qkv = [torch.from_numpy(x) for x in inputs]
        if zigzag:
            qkv = [zigzag_reorder(x, N) for x in qkv]
        attn = make_ring_attention(mesh, "cp", causal=causal, zigzag=zigzag,
                                   impl=impl)
        out[name] = _run_port(attn, *(x.numpy() for x in qkv))
    torch.save(out, f"{store_dir}/rank{rank}.pt")


def _ulysses_rank(rank, store_dir, inputs, inputs_h3):
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.parallel import (
        make_ulysses_attention,
        zigzag_reorder,
        zigzag_restore,
    )

    mesh = init_device_mesh((N,), ("cp",))
    out = {name: _run_port(make_ulysses_attention(mesh, "cp", causal=causal,
                                                  impl=impl), *inputs)
           for name, (impl, causal) in ULYSSES_CASES.items()}
    try:  # 3 heads over 4 ranks
        make_ulysses_attention(mesh, "cp")(*(torch.from_numpy(x)
                                             for x in inputs_h3))
        out["head_error"] = None
    except ValueError as e:
        out["head_error"] = str(e)
    x = torch.arange(64.0).reshape(1, 64, 1)
    z = zigzag_reorder(x, N)
    out["zigzag"] = (z.numpy(), zigzag_restore(z, N).numpy())
    torch.save(out, f"{store_dir}/rank{rank}.pt")


# -- tests -----------------------------------------------------------------
def test_ring_attention_matches_jax(tmp_path):
    """Ring attention with the flash kernels' plain versions as the local
    op (causal, not causal, zigzag) and the einsum oracle (causal, zigzag)
    against ``make_ring_attention`` of the JAX package."""
    from pytorch_distributed_tpu.parallel.context_parallel import (
        make_ring_attention,
        zigzag_reorder,
    )

    inputs = _qkv()
    ctx = ranks.start(_ring_rank, tmp_path, inputs)
    mesh = _jax_mesh()
    want = {}
    for name, (impl, causal, zigzag) in RING_CASES.items():
        qkv = [np.asarray(zigzag_reorder(x, N)) if zigzag else x
               for x in inputs]
        attn = make_ring_attention(mesh, "cp", causal=causal, zigzag=zigzag,
                                   impl=impl)
        want[name] = _run_jax(attn, *qkv)
    ranks.finish(ctx)
    results = _load(tmp_path)
    for name in RING_CASES:
        _assert_ranks_agree_with([r[name] for r in results], want[name], name)


def test_ulysses_and_zigzag_match_jax(tmp_path):
    """Ulysses (flash causal and not, einsum causal) against
    ``make_ulysses_attention`` of the JAX package; heads that the ranks do
    not divide raise; ``zigzag_reorder``/``zigzag_restore`` round-trip as
    JAX's do."""
    from pytorch_distributed_tpu.parallel.context_parallel import (
        make_ulysses_attention,
        zigzag_reorder,
    )

    inputs = _qkv()
    ctx = ranks.start(_ulysses_rank, tmp_path, inputs, _qkv(heads=3, seed=1))
    mesh = _jax_mesh()
    want = {name: _run_jax(make_ulysses_attention(mesh, "cp", causal=causal,
                                                  impl=impl), *inputs)
            for name, (impl, causal) in ULYSSES_CASES.items()}
    ranks.finish(ctx)
    results = _load(tmp_path)
    for name in ULYSSES_CASES:
        _assert_ranks_agree_with([r[name] for r in results], want[name], name)
    x = np.arange(64.0, dtype=np.float32).reshape(1, 64, 1)
    for r in results:
        assert r["head_error"] is not None and "divisible" in r["head_error"]
        z, back = r["zigzag"]
        np.testing.assert_array_equal(z, np.asarray(zigzag_reorder(x, N)))
        assert not np.array_equal(z, x)
        np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_zigzag_positions_are_the_reordered_sequence(n_shards):
    """The ring's zigzag positions of each chunk are the global positions
    that ``zigzag_reorder`` puts there (one process, no group)."""
    from pytorch_distributed_tpu_torch.parallel import context_parallel as cp

    t_local = 8
    order = cp.zigzag_reorder(torch.arange(n_shards * t_local)[None], n_shards)[0]
    for owner in range(n_shards):
        got = cp._chunk_positions(owner, n_shards, t_local, True, "cpu")
        torch.testing.assert_close(
            got.long(), order[owner * t_local:(owner + 1) * t_local])
