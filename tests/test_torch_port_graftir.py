"""The port's graftir (``pytorch_distributed_tpu_torch.analysis.ir``).

Twins of ``tests/test_graftir.py``, in four layers:

* the inventory over ``parallel.comm``'s record, in the reference's HLO
  terms (families, bytes that do not depend on the group's size, the
  scalar/tensor split), and the record itself;
* the audits on the port's own step programs on a one-rank gloo group
  (one spawned process): clean on the real step, and catching a step that
  reallocates a state tensor and a strategy that promises a reduction
  and issues none (the twin of ``test_dropped_donation_is_caught``);
* the committed ``BUDGET.json``: its figures against the reference's
  (76,840 B of DP all-reduce, 76,800 B of ZeRO1 gathers, the fallbacks;
  where the port's state makes a figure differ, the port's figure),
  drift named by ``diff_budget``, the fingerprint tracking content, and
  the CLI gate (``--grid full --diff``, 8 programs on 4 spawned gloo
  ranks) that keeps the audit equal to it;
* on 4 spawned gloo ranks: the probe's DP losses over 3 runner steps
  against the JAX probe ``Trainer``'s at 1e-5, ZeRO1's per-leaf gathers,
  and the in-place sweep of the port's other sites (``fork_pages``, the
  engine's decode step, the redistribution executor's one staging
  buffer, and every ``Program(`` site).

JAX is imported inside the tests only: the ranks re-import this module.
"""
from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.analysis.ir import (
    CHECKS,
    DEFAULT_BUDGET_PATH,
    AuditReport,
    ProgramAudit,
    audit_program,
    build_program,
    collective_inventory,
    diff_budget,
    load_budget,
    summarize_collectives,
)
from pytorch_distributed_tpu_torch.analysis.ir import budget as budget_mod
from pytorch_distributed_tpu_torch.analysis.ir import inventory as inv_mod
from pytorch_distributed_tpu_torch.parallel import comm
from tests import _torch_port_ranks as ranks

pytestmark = pytest.mark.ir

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the probe MLP's parameter bytes: (64 x 256 + 256 + 256 x 10 + 10) x 4
PARAM_BYTES = (64 * 256 + 256 + 256 * 10 + 10) * 4
#: ZeRO1's sharded-update leaves at 4 ranks, min_shard_size 8: both
#: weights and the 256-wide bias; the 10-wide head bias stays whole
DELTA_BYTES = (64 * 256 + 256 + 256 * 10) * 4


# -- the inventory ----------------------------------------------------------
def _calls():
    f32, i64 = torch.float32, torch.int64
    return [
        comm.Call("all_reduce", f32, (256, 10), None, 256 * 10 * 4),
        comm.Call("all_gather", f32, (80,), None, 80 * 4),
        comm.Call("reduce_scatter", f32, (64, 4), None, 64 * 4 * 4),
        comm.Call("send", f32, (5,), None, 20),
        comm.Call("recv", f32, (5,), None, 20),
        comm.Call("barrier", f32, (), None, 0),
        comm.Call("all_reduce", f32, (), None, 4),
        comm.Call("broadcast", i64, (1,), None, 8),
    ]


def test_collective_inventory_families_and_bytes():
    ops = collective_inventory(_calls())
    # a send is its peer's receipt; a barrier carries no tensor
    assert [op.family for op in ops] == [
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
        "all-reduce", "broadcast"]
    ar, ag, rs, cp, loss, bc = ops
    assert ar.bytes == 256 * 10 * 4 and not ar.scalar
    assert ag.bytes == 80 * 4 and rs.bytes == 64 * 4 * 4
    assert cp.bytes == 20 and not cp.scalar
    assert loss.scalar and loss.bytes == 4 and bc.scalar
    assert ar.describe() == "all-reduce float32[256,10] (10240 B)"
    assert set(op.family for op in ops) <= set(inv_mod.COLLECTIVE_FAMILIES)


def test_summarize_separates_scalar_grade():
    summary = summarize_collectives(collective_inventory(_calls()))
    assert summary["tensor"]["all-reduce"] == {"count": 1,
                                               "bytes": 256 * 10 * 4}
    assert summary["scalar"] == {"all-reduce": {"count": 1, "bytes": 4},
                                 "broadcast": {"count": 1, "bytes": 8}}
    assert "all-gather" not in summary["scalar"]


def _comm_record():
    """``parallel.comm``'s record of a few calls on this rank's group."""
    x, world = torch.ones(2, 3), torch.distributed.group.WORLD
    comm.reset_counts()
    with comm.recording() as rec:
        comm.all_reduce(x, world)
        comm.all_gather(torch.empty(2, 3), x, world)
        comm.reduce_scatter(torch.empty(2, 3), x, world)
    comm.broadcast(x, world)
    out = {"names": [c.name for c in comm.calls],
           "recorded": [c.name for c in rec],
           "nbytes": [c.nbytes for c in comm.calls],
           "group_sizes": [op.group_size for op in collective_inventory()]}
    comm.reset_counts()
    out["after_reset"] = (list(comm.calls), collective_inventory())
    limit = comm.CALL_LOG_LIMIT
    comm.CALL_LOG_LIMIT = 1
    try:
        comm.all_reduce(x, world)
        comm.all_reduce(x, world)
        out["kept_dropped"] = (len(comm.calls), comm.calls_dropped)
        try:
            collective_inventory()
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    finally:
        comm.CALL_LOG_LIMIT = limit
        comm.reset_counts()
    return out


def _audited(audit):
    return {"entry": audit.entry, "losses": audit.losses,
            "findings": [(f.rule, f.path, f.message) for f in audit.findings]}


def _one_rank_body(rank, store_dir):
    """The in-process audits on a one-rank gloo group (a spawned process,
    so that no default group is left in the test's worker): the real DP
    step, a step that reallocates a state tensor, a DP strategy that
    issues no reduction, ZeRO1 in fp16, and the comm record."""
    out = {"comm": _comm_record()}
    program = build_program("dp", "fp32")
    out["param_bytes"] = program.param_bytes()
    out["dp"] = _audited(audit_program(program))

    program = build_program("dp", "fp32")
    trainer = program.trainer
    body = trainer.step_body

    def reallocating(state, batch):
        result = body(state, batch)
        w = trainer.model.Dense_0.weight
        w.data = w.data.clone()
        return result

    trainer.step_body = reallocating
    out["reallocating"] = _audited(audit_program(program))

    program = build_program("dp", "fp32")
    program.trainer.strategy.reduce_grads = lambda grads: grads
    out["no_reduction"] = _audited(audit_program(program))
    out["zero1_fp16"] = _audited(audit_program(build_program("zero1",
                                                             "fp16")))
    torch.save(out, f"{store_dir}/one_rank.pt")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_rank")
    ranks.finish(ranks.start(_one_rank_body, tmp, world=1))
    return torch.load(f"{tmp}/one_rank.pt", weights_only=False)


def test_comm_records_each_call_in_hlo_terms(one_rank):
    """Each call is recorded with the bytes of the HLO result: the tensor
    reduced (a reduce-scatter's whole input), the whole gathered tensor;
    ``recording()`` collects a block's calls apart; ``reset_counts``
    clears the record; past its limit the record drops and the inventory
    refuses."""
    rec = one_rank["comm"]
    assert rec["names"] == [
        "all_reduce", "all_gather", "reduce_scatter", "broadcast"]
    assert rec["recorded"] == rec["names"][:3]
    assert rec["nbytes"] == [24, 24, 24, 24]
    assert rec["group_sizes"] == [1, 1, 1, 1]
    assert rec["after_reset"] == ([], [])
    assert rec["kept_dropped"] == (1, 1)
    assert "dropped" in rec["refused"]


# -- the audits in-process (one rank) --------------------------------------
def test_dp_audit_clean_with_expected_budget(one_rank):
    assert one_rank["param_bytes"] == PARAM_BYTES
    audit = one_rank["dp"]
    assert not audit["findings"], audit["findings"]
    tensor = audit["entry"]["collectives"]["tensor"]
    assert tensor == {"all-reduce": {"count": 1, "bytes": PARAM_BYTES}}
    assert audit["entry"]["donation"] == {"donated": 8, "realized": 8}
    runner = audit["entry"]["runner"]
    assert runner["dispatches"] == runner["submits"] == 3
    assert runner["executables"] == 1
    assert runner["programs_per_step"] == 1.0
    # the runner's step tensors and its metric ring's idx and buf
    assert runner["donation"] == {"donated": 10, "realized": 10}
    assert np.all(np.isfinite(audit["losses"])) and len(audit["losses"]) == 3


def test_reallocated_state_tensor_is_caught(one_rank):
    """The teeth: a step that reallocates a state tensor (a parameter
    given new storage each step) is named by the in-place check, in the
    step's entry and the runner's."""
    audit = one_rank["reallocating"]
    moved = [f for f in audit["findings"] if f[0] == "ir-donation-aliasing"]
    assert len(moved) == 2, audit["findings"]
    assert all("param.Dense_0.weight" in f[2] for f in moved)
    assert {f[1] for f in moved} == {"ir:dp:fp32", "ir:dp:fp32[runner]"}
    assert audit["entry"]["donation"] == {"donated": 8, "realized": 7}


def test_dropped_reduction_is_caught(one_rank):
    """A strategy that promises a gradient reduction and issues none is
    caught by the collective budget."""
    audit = one_rank["no_reduction"]
    assert {f[0] for f in audit["findings"]} == {"ir-collective-budget"}, (
        audit["findings"])
    assert "promises a gradient reduction" in audit["findings"][0][2]
    assert audit["entry"]["collectives"]["tensor"] == {}


def test_sharded_layout_is_held_as_declared(one_rank):
    """At one rank ZeRO1's blocks are whole; the audit still reads the
    declared layout and the rank's bytes."""
    audit = one_rank["zero1_fp16"]
    assert not audit["findings"], audit["findings"]
    sharding = audit["entry"]["sharding"]
    assert sharding["param_bytes"] == sharding["opt_bytes"] == PARAM_BYTES
    assert sharding["fallbacks"] == {"trivial_axis": 4}
    # 4 params, 4 momenta and the scaler's two: no block at one rank
    assert audit["entry"]["donation"] == {"donated": 10, "realized": 10}


# -- the committed budget ---------------------------------------------------
@pytest.fixture(scope="module")
def budget():
    return load_budget(DEFAULT_BUDGET_PATH)


def _report(budget):
    return AuditReport(
        grid=budget["grid"], platform=budget["platform"],
        device_count=budget["device_count"],
        audits=[ProgramAudit(name=n, entry=copy.deepcopy(e), findings=[])
                for n, e in budget["programs"].items()])


def test_budget_is_the_full_grid_on_four_cpu_ranks(budget):
    assert (budget["platform"], budget["device_count"], budget["grid"]) == (
        "cpu", 4, "full")
    assert sorted(budget["programs"]) == sorted(
        f"{s}:{a}" for s in ("dp", "zero1", "fsdp", "hybrid")
        for a in ("fp32", "fp16"))


def test_budget_figures_against_the_reference(budget):
    """The reference's figures, as the port holds them. DP's gradient
    all-reduce moves exactly the parameter bytes (one flat fp32 buffer:
    one call, where the reference's compiled step has 4) and nothing is
    gathered; ZeRO1's gathers total the sharded-update leaves' bytes, 3
    of them; the fallbacks of the strategies sharding over a 4-wide axis
    are the reference's. The port's own figures: HybridShard's fsdp axis
    is 2 wide at 4 ranks (the reference's 4 at 8 devices), which divides
    the head bias; the in-place counts are 8 (fp32) and 10 (fp16) under
    DP where the reference donates 9 and 11 (the port's step count is a
    host int, not a state leaf), and ZeRO1 adds its 3 blocks."""
    progs = budget["programs"]
    for amp in ("fp32", "fp16"):
        dp = progs[f"dp:{amp}"]["collectives"]["tensor"]
        assert dp == {"all-reduce": {"count": 1, "bytes": PARAM_BYTES}}
        z = progs[f"zero1:{amp}"]["collectives"]["tensor"]
        assert z["all-gather"] == {"count": 3, "bytes": DELTA_BYTES}
        assert z["reduce-scatter"]["bytes"] == DELTA_BYTES
        for s in ("zero1", "fsdp"):
            assert progs[f"{s}:{amp}"]["sharding"]["fallbacks"] == {
                "indivisible": 1, "sharded": 3}
        assert progs[f"hybrid:{amp}"]["sharding"]["fallbacks"] == {
            "sharded": 4}
    donated = {n: e["donation"]["donated"] for n, e in progs.items()}
    assert donated["dp:fp32"] == 8 and donated["dp:fp16"] == 10
    assert donated["zero1:fp32"] == 11 and donated["zero1:fp16"] == 13
    for name, e in progs.items():
        assert e["donation"]["realized"] == e["donation"]["donated"], name
        r = e["runner"]
        assert (r["dispatches"], r["executables"], r["programs_per_step"]) \
            == (r["submits"], 1, 1.0), name
        assert r["donation"]["donated"] == e["donation"]["donated"] + 2


def test_budget_diff_names_the_drift(budget):
    report = _report(budget)
    payload = budget_mod.budget_payload(report)
    same, diffs = diff_budget(payload, report)
    assert same and not diffs

    mutated = copy.deepcopy(payload)
    mutated["programs"]["zero1:fp32"]["donation"]["realized"] = 0
    comparable, diffs = diff_budget(mutated, report)
    assert comparable
    assert any("donation.realized" in d and "0 -> 11" in d
               for d in diffs), diffs

    foreign = dict(payload, platform="gpu")
    comparable, notes = diff_budget(foreign, report)
    assert not comparable and notes


def test_budget_fingerprint_tracks_content(budget):
    report = _report(budget)
    a = budget_mod.budget_payload(report)
    assert a["fingerprint"] == budget["fingerprint"]
    assert budget_mod.budget_payload(report)["fingerprint"] == a[
        "fingerprint"]
    report.audits[0].entry["donation"]["realized"] = 0
    assert budget_mod.budget_payload(report)["fingerprint"] != a[
        "fingerprint"]


def _run_graftir(*argv):
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.analysis.ir",
         *argv],
        capture_output=True, text=True, cwd=REPO_ROOT,
    )


def test_cli_list_checks():
    proc = _run_graftir("--list-checks")
    assert proc.returncode == 0
    for name in CHECKS:
        assert name in proc.stdout
    assert len(CHECKS) == 5


def test_repo_ir_full_grid_is_clean():
    """The gate: the full grid (DP, ZeRO1, FSDP, HybridShard x fp32/fp16)
    on 4 spawned gloo ranks audits clean AND matches the committed
    BUDGET.json."""
    proc = _run_graftir("--grid", "full", "--diff", "--format", "json")
    assert proc.returncode == 0, (
        f"graftir found regressions:\n{proc.stdout}\n{proc.stderr[-4000:]}"
    )
    payload = json.loads(proc.stdout)
    assert payload["summary"]["findings"] == 0
    assert payload["summary"]["files"] == 8
    assert payload["summary"]["rules_run"] == sorted(CHECKS)


# -- on 4 gloo ranks: the probe against JAX, and the in-place sweep -------
def _staging_sweep(rank):
    """A (16, 24) tensor row-sharded over 4 ranks moved to column blocks
    on ranks 0 and 1 under a 160-byte staging budget: every chunk's sends
    and receives are views of one staging buffer."""
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.redistribute import (
        Placed,
        Sharding,
        executor,
        redistribute,
    )

    a4 = init_device_mesh((4,), ("a",))
    a2 = init_device_mesh((2,), ("a",), ranks=(0, 1))
    ref = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    x = Placed(ref[4 * rank:4 * rank + 4].clone(), Sharding(a4, ("a", None)),
               (16, 24), torch.float32)
    storages, real = [], comm.p2p

    def spy(group, sends=(), recvs=()):
        storages.append({t.untyped_storage().data_ptr()
                         for t, _ in list(sends) + list(recvs)})
        return real(group, sends, recvs)

    comm.p2p = spy
    try:
        executor.reset_counts()
        there = redistribute(x, Sharding(a2, (None, "a")),
                             max_staging_bytes=160)
    finally:
        comm.p2p = real
    want = ref[:, 12 * rank:12 * rank + 12] if rank < 2 else None
    return {"storages": storages,
            "staging_max": executor.counts["staging_bytes_max"],
            "right": (there is None) if want is None
            else torch.equal(there, want)}


def _probe_rank(rank, store_dir, state_dict):
    from pytorch_distributed_tpu_torch.analysis.ir import (
        audit_program,
        build_program,
        collective_inventory,
    )

    program = build_program("dp", "fp32", state_dict=state_dict)
    audit = audit_program(program)
    zero1 = build_program("zero1", "fp32")
    _, calls = zero1.trainer.step_artifacts(zero1.state, zero1.batch)
    out = {
        "losses": audit.losses,
        "findings": [f.render() for f in audit.findings],
        "gathers": [op.bytes for op in collective_inventory(calls)
                    if op.family == "all-gather"],
        "staging": _staging_sweep(rank),
    }
    torch.save(out, f"{store_dir}/probe.rank{rank}.pt")


def _jax_probe(steps):
    """The JAX probe Trainer (the reference's flax ``_mlp``, SGD(0.1,
    momentum 0.9), DataParallel on 4 virtual devices) on
    ``_host_batch(8)``: its initial weights as the port's state dict and
    its losses over ``steps`` steps of the same batch."""
    import jax
    import optax

    from pytorch_distributed_tpu.analysis.ir.programs import (
        _host_batch,
        _mlp,
    )
    from pytorch_distributed_tpu.mesh import init_device_mesh
    from pytorch_distributed_tpu.parallel import DataParallel
    from pytorch_distributed_tpu.trainer import Trainer

    mesh = init_device_mesh((4,), ("dp",), devices=jax.devices()[:4])
    trainer = Trainer(_mlp(), optax.sgd(0.1, momentum=0.9),
                      DataParallel(mesh))
    batch = _host_batch(8)
    state = trainer.init(jax.random.key(0), batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    sd = {}
    for i in range(2):
        d = params[f"Dense_{i}"]
        sd[f"Dense_{i}.weight"] = torch.tensor(d["kernel"].T.copy())
        sd[f"Dense_{i}.bias"] = torch.tensor(d["bias"])
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
    return sd, losses


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe")
    sd, want = _jax_probe(3)
    ctx = ranks.start(_probe_rank, tmp, sd)
    ranks.finish(ctx)
    got = [torch.load(f"{tmp}/probe.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return got, want


def test_probe_losses_match_the_jax_probe(probe):
    """The 4-rank DP probe's losses over 3 runner steps (the mean of the
    ranks' shares) against the JAX probe Trainer's at 1e-5, with the
    audit clean on every rank."""
    got, want = probe
    for res in got:
        assert not res["findings"], res["findings"]
    mean = np.mean([res["losses"] for res in got], axis=0)
    np.testing.assert_allclose(mean, want, rtol=1e-5)


def test_zero1_gathers_stay_per_leaf(probe):
    got, _ = probe
    for res in got:
        assert sorted(res["gathers"]) == [256 * 4, 256 * 10 * 4,
                                          64 * 256 * 4]
        assert max(res["gathers"]) <= 65536 and sum(res["gathers"]) == \
            DELTA_BYTES


def test_redistribute_streams_every_chunk_through_one_buffer(probe):
    got, _ = probe
    for rank, res in enumerate(got):
        st = res["staging"]
        assert st["right"], rank
        assert st["staging_max"] <= 160
        assert len(st["storages"]) > 1, rank      # several chunks
        assert len(set().union(*st["storages"])) == 1, rank


# -- the in-place sweep, in-process ----------------------------------------
TINY = dict(vocab_size=32, n_positions=32, n_embd=16, n_layer=2, n_head=2)


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def test_fork_pages_keeps_the_pool_in_place():
    """The paged COW fork copies a page inside the pool: every cache
    tensor keeps its address (the reference donates the whole cache)."""
    from pytorch_distributed_tpu_torch.analysis.ir import inplace_findings
    from pytorch_distributed_tpu_torch.models import GPT2Config
    from pytorch_distributed_tpu_torch.serving.engine import _state_tensors
    from pytorch_distributed_tpu_torch.serving.paging import (
        PagedKVCache,
        fork_pages,
    )

    cache = PagedKVCache.create(GPT2Config(**TINY), n_slots=2, max_len=16,
                                page_size=4, device="cpu")
    cache.k.normal_()
    cache.v.normal_()
    tensors = _state_tensors(cache)
    before = _ptrs(tensors)
    out = fork_pages(cache, 1, 2)
    assert out is cache
    assert torch.equal(cache.k[:, 2], cache.k[:, 1])
    assert torch.equal(cache.v[:, 2], cache.v[:, 1])
    entry, findings = inplace_findings(
        "fork_pages", ["k", "v", "lengths", "block_tables"], before,
        _ptrs(_state_tensors(cache)))
    assert not findings and entry == {"donated": 4, "realized": 4}


@pytest.mark.parametrize("kind", ["slotted", "paged"])
def test_engine_decode_keeps_its_cache_in_place(kind):
    """The engine's decode step (its ``Program``: a graph replay on the
    card, the eager body here) writes the cache in place, one program a
    cache, however many steps."""
    from pytorch_distributed_tpu_torch.analysis.ir import inplace_findings
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import InferenceEngine
    from pytorch_distributed_tpu_torch.serving.engine import _state_tensors

    model = GPT2(GPT2Config(**TINY), device="cpu", seed=0)
    engine = InferenceEngine(model, n_slots=2, max_len=16, device="cpu",
                             cache_kind=kind, page_size=4)
    cache = engine.init_cache()
    before = _ptrs(_state_tensors(cache))
    lengths = cache.lengths.clone()
    for _ in range(3):
        cache, toks = engine.decode(cache, np.array([3, 5]),
                                    np.array([True, True]))
    assert toks.shape == (2,)
    assert torch.equal(cache.lengths, lengths + 3)
    entry, findings = inplace_findings(
        f"serving.decode[{kind}]", [f"cache{i}" for i in range(len(before))],
        before, _ptrs(_state_tensors(cache)))
    assert not findings and entry["donated"] == entry["realized"] >= 3
    assert len(engine._programs) == 1


def test_program_site_sweep_is_complete():
    """Every ``Program(`` site of the port is audited: the runner's step
    (the audits above, the CLI gate) and the serving engine's (the decode
    sweep above). A new site must be added here WITH an in-place test."""
    audited = {
        "pytorch_distributed_tpu_torch/pipeline_exec/runner.py",
        "pytorch_distributed_tpu_torch/serving/engine.py",
    }
    found = set()
    pkg = os.path.join(REPO_ROOT, "pytorch_distributed_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames
                       if d not in ("analysis", "__pycache__")]
        for fn in filenames:
            if not fn.endswith(".py") or fn == "_graphs.py":
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as fh:
                if re.search(r"(?<![\w.])Program\(", fh.read()):
                    found.add(os.path.relpath(path, REPO_ROOT))
    assert found == audited, (
        f"Program sites changed: +{found - audited} -{audited - found}: "
        f"extend the graftir in-place sweep for new sites"
    )
