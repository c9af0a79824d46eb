"""The port's redistribution executor and its call sites on 4 gloo ranks.

Rank bodies in ``tests/_torch_port_redistribute.py``, spawned once per
fixture (``tests/_torch_port_ranks.py``); the JAX side runs in this
process on the conftest's 8 virtual CPU devices while the ranks work.

* The executor against JAX's index maps: ``tests/test_redistribute.py``'s
  round trips on 4 ranks (transpose, swap-axes, a regroup across meshes, a
  slice-down), an all-gather, a transition mixing axes, a shrink to ranks
  0 and 1 chunked under ``max_staging_bytes``, a growth from ranks 2 and 3,
  a host source and a 3-D bf16 tensor: every destination block is the
  slice JAX's ``devices_indices_map`` names, bit for bit, and the way back
  gives the source block back; the all-to-all's and the mixed
  transition's sent bytes stay within the planned ``bytes_moved``; the
  staging buffer never exceeds its budget; no temporary buffer of a leaf
  with a sharded destination holds the whole leaf.
* ``reshard_state`` from FSDP over 4 ranks to FSDP over ranks 0 and 1:
  the blocks equal JAX ``reshard_state``'s shards on 4 -> 2 virtual
  devices and, loaded through ``set_state_dict``, the state that
  ``resume_from_checkpoint`` loads at dp 2 from a checkpoint of the same
  state, bit for bit (and the next step's loss with it).
* ``reshard_gpt2_params`` from FSDP(4) to TP(1, 4): the blocks
  ``shard_gpt2_params`` cuts, and greedy streams equal to the JAX
  engine's on both caches; a staged ``swap_params`` mid-stream from
  other weights laid out FSDP over ranks 2 and 3: streams equal to the
  JAX ``Scheduler``'s across the same swap, every ``data_ptr`` kept, the
  event's ``peak_bytes`` and ``naive_gather_bytes``.
* ``examples/reshard_checkpoint.py``'s twin at ``--device cpu`` under 4
  gloo ranks (``elastic.run``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_redistribute as rd
from tests import _torch_port_tp as tph

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CASES = [
    dict(name="transpose", src="a4", src_spec=("a", None), dst="a4",
         dst_spec=(None, "a")),
    dict(name="swap-axes", src="ab22", src_spec=("a", "b"), dst="ab22",
         dst_spec=("b", "a")),
    dict(name="regroup", src="a4", src_spec=("a", None), dst="ab22",
         dst_spec=(("a", "b"), None)),
    dict(name="slice-down", src="a4", src_spec=(None, None), dst="ab22",
         dst_spec=("a", "b")),
    dict(name="gather", src="ab22", src_spec=("a", "b"), dst="ab22",
         dst_spec=("a", None)),
    dict(name="mixed", src="ab22", src_spec=(("a", "b"), None), dst="ab22",
         dst_spec=(None, ("b", "a"))),
    dict(name="shrink-staged", src="a4", src_spec=("a", None), dst="a2lo",
         dst_spec=(None, "a"), staging=160),
    dict(name="grow", src="a2hi", src_spec=("a", None), dst="a4",
         dst_spec=(None, "a")),
    dict(name="host", src=None, dst="ab22", dst_spec=(None, "b"),
         staging=96),
    dict(name="bf16-3d", src="ab22", src_spec=(None, "a", "b"), dst="a4",
         dst_spec=("a", None, None), shape=(4, 8, 6), dtype=torch.bfloat16),
]
NAMES = [c["name"] for c in CASES]


def index_map(key, spec, shape):
    """``{rank: box}`` of JAX's ``devices_indices_map`` for the mesh
    ``key`` of ``rd.MESHES`` (its ranks as device ids)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mshape, names, on = rd.MESHES[key]
    on = on or tuple(range(int(np.prod(mshape))))
    devs = np.asarray([jax.devices()[r] for r in on]).reshape(mshape)
    m = NamedSharding(Mesh(devs, names), P(*spec)).devices_indices_map(shape)
    return {d.id: tuple((s.start or 0, n if s.stop is None else s.stop)
                        for s, n in zip(sl, shape)) for d, sl in m.items()}


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exec")
    cases = []
    for c in CASES:
        shape = c.get("shape", (16, 24))
        c = dict(c, seed=len(cases))
        if c["src"] is not None:
            c["src_idx"] = index_map(c["src"], c["src_spec"], shape)
        c["dst_idx"] = index_map(c["dst"], c["dst_spec"], shape)
        cases.append(c)
    ctx = ranks.start(rd.exec_body, tmp, cases)
    ranks.finish(ctx, timeout=120)
    got = [torch.load(f"{tmp}/exec.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return {c["name"]: c for c in cases}, got


@pytest.mark.parametrize("name", NAMES)
def test_round_trips_are_bit_exact(executed, name):
    cases, got = executed
    case = cases[name]
    ref = rd.case_array(case)
    for r in range(ranks.WORLD):
        out = got[r][name]
        box = case["dst_idx"].get(r)
        if box is None:
            assert out["there"] is None, r
        else:
            want = ref[tuple(slice(lo, hi) for lo, hi in box)]
            assert out["there"].dtype == ref.dtype
            assert torch.equal(out["there"], want), (name, r)
        if case["src"] is not None:
            assert out["back_exact"], (name, r)


@pytest.mark.parametrize("name,op", [("transpose", "all_to_all"),
                                     ("mixed", "all_to_all"),
                                     ("gather", "all_gather")])
def test_sent_bytes_within_the_planned_bytes(executed, name, op):
    _, got = executed
    for r in range(ranks.WORLD):
        out = got[r][name]
        assert out["ops"] == (op,)
        assert 0 < out["counts"]["sent_bytes"] <= out["cost"].bytes_moved, r


def test_swap_axes_real_bytes_against_the_uncorrelated_model(executed):
    """The planner assumes uncorrelated placement (a quarter of each dst
    block local); swapping the axes of a (2, 2) mesh keeps the diagonal
    ranks' blocks and sends the others' whole: real bytes per rank are
    0 or the whole block, the plan's 3/4 of it on every rank."""
    _, got = executed
    block = 16 * 24 * 4 // 4
    sent = [got[r]["swap-axes"]["counts"]["sent_bytes"]
            for r in range(ranks.WORLD)]
    assert sent == [0, block, block, 0]
    assert got[0]["swap-axes"]["cost"].bytes_moved == block * 3 // 4


def test_staging_never_exceeds_its_budget(executed):
    cases, got = executed
    budget = cases["shrink-staged"]["staging"]
    staged = [got[r]["shrink-staged"]["counts"]["staging_bytes_max"]
              for r in range(ranks.WORLD)]
    assert got[0]["shrink-staged"]["chunks"] > 1
    assert all(0 < s <= budget for s in staged), staged
    # every rank sends (0 and 1 each other's columns, 2 and 3 all they
    # hold); the regroup, the slice and the host copy move nothing
    for r in range(ranks.WORLD):
        assert got[r]["shrink-staged"]["counts"]["sent_bytes"] == (
            4 * 12 * 4 if r < 2 else 4 * 24 * 4)
        for name in ("regroup", "slice-down", "host"):
            assert got[r][name]["counts"]["sent_bytes"] == 0, (name, r)


def test_no_sharded_destination_is_gathered_whole(executed):
    cases, got = executed
    for name, case in cases.items():
        if all(not axes for axes in case["dst_spec"]):
            continue
        ref = rd.case_array(case)
        total = rd.total_bytes(ref.shape, ref.dtype)
        for r in range(ranks.WORLD):
            assert got[r][name]["counts"]["buffer_bytes_max"] < total, (name,
                                                                       r)


# -- reshard_state: 4 -> 2 --------------------------------------------------
@pytest.fixture(scope="module")
def resized(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("state")
    ctx = ranks.start(rd.state_body, tmp, str(tmp / "ckpt"), 4096)
    ranks.finish(ctx, timeout=150)
    return [torch.load(f"{tmp}/state.rank{r}.pt", weights_only=False)
            for r in range(ranks.WORLD)]


def test_reshard_state_equals_jax_reshard_state(resized):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pytorch_distributed_tpu.elastic import reshard_state as jax_reshard

    devs = jax.devices()
    mesh4 = Mesh(np.asarray(devs[:4]), ("fsdp",))
    mesh2 = Mesh(np.asarray(devs[:2]), ("fsdp",))
    state, targets, keys = {}, {}, []
    for k, dims in resized[0]["src_dims"].items():
        whole = rd.global_of([resized[r]["src"][k] for r in range(4)], dims)
        if not whole.is_floating_point():
            continue
        spec = [None] * whole.dim()
        for d in dims:
            spec[d] = "fsdp"
        state[k] = jax.device_put(whole.numpy(), NamedSharding(mesh4,
                                                               P(*spec)))
        dst = resized[0]["dst_specs"][k]
        targets[k] = NamedSharding(mesh2, P(*[a[0] if a else None
                                              for a in dst]))
        keys.append(k)
    out = jax_reshard(state, targets)
    assert len(keys) > 20
    for k in keys:
        shards = {s.device.id: np.asarray(s.data)
                  for s in out[k].addressable_shards}
        for r in range(4):
            got = resized[r]["moved"][k]
            if r >= 2:
                assert got is None, (k, r)
                continue
            np.testing.assert_array_equal(got.numpy(), shards[r], err_msg=k)


def test_reshard_state_equals_the_checkpoint_resume(resized):
    for r in range(2):
        res = resized[r]
        assert res["steps"] == (rd.STATE_STEPS, rd.STATE_STEPS)
        assert set(res["resized"]) == set(res["resumed"])
        for k, t in res["resumed"].items():
            assert torch.equal(res["resized"][k], t), (r, k)
        a, b = res["losses"]
        assert a == b and np.isfinite(a)
    # some leaves crossed rank sets under the staging budget
    staged = [resized[r]["counts"]["staging_bytes_max"] for r in range(4)]
    assert max(staged) > 0 and all(s <= 4096 for s in staged), staged
    assert all(resized[r]["counts"]["sent_bytes"] > 0 for r in (1, 2, 3))


# -- serving: reshard_gpt2_params and the staged swap ------------------------
def _jax_tiny(seed):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    jmodel = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.SERVE))
    variables = jmodel.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    sd = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    return jmodel, variables, sd


def _jax_streams(jmodel, variables, other):
    from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler

    plain, swapped = {}, {}
    for kind in ("slotted", "paged"):
        kw = dict(n_slots=3, max_len=40, prefill_len=16)
        if kind == "paged":
            kw.update(cache_kind="paged", page_size=4)
        sched = JaxScheduler(JaxEngine(jmodel, variables, **kw),
                             emit_events=False)
        for prompt, n_new in tph.serve_requests():
            sched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
        plain[kind] = {f.request_id: list(f.tokens) for f in sched.run()}
        kw = dict(n_slots=2, max_len=32, prefill_len=8)
        if kind == "paged":
            kw.update(cache_kind="paged", page_size=4)
        sched = JaxScheduler(JaxEngine(jmodel, variables, **kw),
                             emit_events=False)
        for p in rd.swap_prompts():
            sched.submit(JaxRequest(prompt=p, max_new_tokens=12))
        for _ in range(rd.SWAP_AT):
            sched.step()
        sched.swap_params(other)
        swapped[kind] = {f.request_id: list(f.tokens) for f in sched.run()}
    return plain, swapped


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    jmodel, variables, sd = _jax_tiny(0)
    _, other_vars, other = _jax_tiny(5)
    ctx = ranks.start(rd.serve_body, tmp, sd, other)
    want = _jax_streams(jmodel, variables, other_vars)
    ranks.finish(ctx, timeout=180)
    got = [torch.load(f"{tmp}/serve.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return got, want


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_reshard_fsdp_to_tp_serves_the_jax_streams(served, kind):
    got, (plain, _) = served
    for r, out in enumerate(got):
        assert out["blocks_equal"], r
        assert out["streams"][kind] == plain[kind], r
        sent = out["reshard_counts"]["sent_bytes"]
        assert 0 < sent <= out["reshard_cost"].bytes_moved
        assert out["reshard_cost"].peak_bytes < \
            out["reshard_cost"].naive_gather_bytes


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_staged_swap_mid_stream_matches_the_jax_scheduler(served, kind):
    from pytorch_distributed_tpu_torch.redistribute import TransferCost

    got, (_, swapped) = served
    for r, out in enumerate(got):
        s = out["swap"][kind]
        assert s["streams"] == swapped[kind], r
        assert s["ptrs_kept"] and s["replays"] == 0
        assert isinstance(s["cost"], TransferCost)
        ev = s["event"]
        assert ev["bytes_moved"] == s["cost"].bytes_moved > 0
        assert ev["peak_bytes"] == s["cost"].peak_bytes
        assert ev["naive_gather_bytes"] == s["cost"].naive_gather_bytes
        assert 0 < s["counts"]["staging_bytes_max"] <= rd.SWAP_STAGING
        assert (s["counts"]["sent_bytes"] > 0) == (r >= 2)


def test_reshard_example_on_four_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.elastic.run",
         "--standalone", "--nproc-per-node", "4", "--max-restarts", "0",
         "--log-dir", str(tmp_path / "logs"), "-m",
         "pytorch_distributed_tpu_torch.examples.reshard_checkpoint",
         "--device", "cpu", "--tp", "2", "--max-new-tokens", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = proc.stdout + "".join(
        p.read_text() for p in (tmp_path / "logs").rglob("*.log"))
    assert "host -> train mesh (4-way fsdp): moved" in log
    assert "onto serving mesh (dp=2, tp=2)" in log
    assert "match the teacher-forcing oracle straight through the swap" in log
    assert "weight swaps: 1" in log


def test_reshard_example_plan_only():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m",
         "pytorch_distributed_tpu_torch.examples.reshard_checkpoint",
         "--device", "cpu", "--plan-only"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("host -> train mesh (1-way fsdp): moved")
    assert any("device_put" in line for line in lines[1:])
