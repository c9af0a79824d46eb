"""graftir checks: the audits over one step program, with their torch
meaning.

Port of ``pytorch_distributed_tpu/analysis/ir/audit.py``; the check names
are the reference's, so that a report's ``rules_run`` and a matrix's stamp
line up:

1. **collective budget** (``ir-collective-budget``): the step's
   tensor-grade collectives (the inventory ``Trainer.step_artifacts``
   recorded, ``inventory.collective_inventory``) against the strategy's
   :meth:`collective_signature`: a gradient reduction where one is
   promised, no parameter gather under ``"none"``, ``"delta"`` gathers
   totalling exactly the sharded-update leaves' bytes with none larger
   than the largest leaf, ``"per_param"`` gathers present with none as
   large as all the parameters, no forbidden family.
2. **in-place update** (``ir-donation-aliasing``): the reference checks
   that each donated state leaf is aliased to an output, so XLA reuses its
   buffer; the port's counterpart is that the step updates its state in
   place. After a step every tensor of ``pipeline_exec.runner``'s
   ``_step_tensors`` (parameters, buffers, ZeRO1's blocks, optimizer and
   scaler state) keeps its ``data_ptr``, and on the runner path so do the
   metric ring's. A tensor that moved is a copy per step, and a captured
   graph would go on reading the old one. ``donated`` counts the tensors,
   ``realized`` those that stayed.
3. **program count** (``ir-program-count``): drive a real
   :class:`AsyncRunner` and require one dispatch per submit, one built
   ``Program`` after same-shape submits, and ``programs_per_step == 1``,
   as structure, not as a stamped number. The runtime counterpart of the
   reference lint tier's ``recompile-hazard``.
4. **sharding propagation** (``ir-sharding-propagation``): every leaf that
   ``make_state_specs`` declares sharded is held as its block on this
   rank, and the rank's parameter and optimizer bytes are the declared
   layout's; the fallbacks of ``shard_spec_with_reason`` are counted into
   the budget so they can't silently grow.
5. **budget drift** (``ir-budget-drift``): the numbers above against the
   committed ``BUDGET.json`` (``budget.diff_budget``).

Findings reuse graftlint's :class:`~..core.Finding`, so the reporters,
JSON schema and fingerprints are shared by both tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from pytorch_distributed_tpu_torch.analysis.core import Finding
from pytorch_distributed_tpu_torch.analysis.ir import inventory as inv_mod
from pytorch_distributed_tpu_torch.analysis.ir.programs import (
    StepProgram,
    build_grid,
)

__all__ = [
    "CHECKS",
    "ProgramAudit",
    "AuditReport",
    "collective_findings",
    "inplace_findings",
    "runner_audit",
    "sharding_findings",
    "audit_program",
    "run_audit",
]

#: the check catalog (rule name -> one-line description); RULES.md "IR
#: tier" documents each with the failure it guards against
CHECKS = {
    "ir-collective-budget": (
        "tensor-grade collective set matches the strategy's declared "
        "signature (reduction present, gather policy, no forbidden ops)"
    ),
    "ir-donation-aliasing": (
        "every state tensor the step updates (and the runner's metric "
        "ring) keeps its address: the update is in place"
    ),
    "ir-program-count": (
        "AsyncRunner path dispatches exactly one program per step "
        "against one built Program"
    ),
    "ir-sharding-propagation": (
        "every leaf the strategy declares sharded is held as its block, "
        "in the rank's parameter and optimizer bytes"
    ),
    "ir-budget-drift": (
        "collective bytes/counts, in-place counts, or sharding changed vs "
        "the committed BUDGET.json without regeneration"
    ),
}


def _finding(rule: str, program: str, message: str) -> Finding:
    return Finding(
        rule=rule, path=f"ir:{program}", line=1, col=1,
        message=message, symbol=program,
    )


@dataclasses.dataclass
class ProgramAudit:
    """Outcome of auditing one step program: the budget entry (the facts
    the baseline pins), any contract violations, and the losses of the
    runner's steps (not pinned: values, not structure)."""

    name: str
    entry: Dict
    findings: List[Finding]
    losses: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AuditReport:
    grid: str
    platform: str
    device_count: int
    audits: List[ProgramAudit]

    @property
    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        for a in self.audits:
            out.extend(a.findings)
        return out

    @property
    def entries(self) -> Dict[str, Dict]:
        return {a.name: a.entry for a in self.audits}

    @property
    def clean(self) -> bool:
        return not self.findings


# -- check 1: collective budget -------------------------------------------
def _delta_gather_leaves(program: StepProgram) -> List[Tuple[str, int]]:
    """The leaves whose update is sharded and whose parameter is whole:
    what ZeRO1 gathers back, whole, after the step."""
    strategy = program.strategy
    out = []
    for name, shape in program.shapes.items():
        if (strategy.update_pspec(name, shape) is not None
                and strategy.param_pspec(name, shape) is None):
            numel = 1
            for d in shape:
                numel *= d
            out.append((name, numel * 4))
    return out


def collective_findings(
    program: StepProgram, ops: Sequence[inv_mod.CollectiveOp]
) -> List[Finding]:
    name = program.name
    sig = program.strategy.collective_signature()
    findings: List[Finding] = []
    tensor = [op for op in ops if not op.scalar]

    for op in tensor:
        if op.family in sig["forbid"]:
            findings.append(_finding(
                "ir-collective-budget", name,
                f"forbidden collective in train step: {op.describe()}",
            ))

    reduces = [op for op in tensor if op.family in inv_mod.REDUCE_FAMILIES]
    gathers = [op for op in tensor if op.family in inv_mod.GATHER_FAMILIES]

    if sig["grad_reduce"] and not reduces:
        findings.append(_finding(
            "ir-collective-budget", name,
            "strategy promises a gradient reduction but the step issues "
            "no tensor-grade all-reduce/reduce-scatter: gradients are not "
            "being synchronized",
        ))
    if not sig["grad_reduce"] and reduces:
        findings.append(_finding(
            "ir-collective-budget", name,
            f"unexpected tensor-grade reduction(s) for a no-sync "
            f"strategy: {', '.join(op.describe() for op in reduces)}",
        ))

    total_param_bytes = program.param_bytes()
    policy = sig["param_gather"]
    if policy == "none":
        for op in gathers:
            findings.append(_finding(
                "ir-collective-budget", name,
                f"tensor-grade all-gather in a replicated-param "
                f"strategy: {op.describe()}: params should never be "
                f"gathered under pure DP",
            ))
    elif policy == "delta":
        delta = _delta_gather_leaves(program)
        expected = sum(b for _, b in delta)
        got = sum(op.bytes for op in gathers)
        if got != expected:
            findings.append(_finding(
                "ir-collective-budget", name,
                f"delta all-gather bytes {got} != {expected} expected "
                f"for {len(delta)} sharded-update leaves "
                f"({', '.join(p for p, _ in delta)})",
            ))
        biggest_leaf = max((b for _, b in delta), default=0)
        for op in gathers:
            if op.bytes > biggest_leaf:
                findings.append(_finding(
                    "ir-collective-budget", name,
                    f"monolithic all-gather {op.describe()} exceeds the "
                    f"largest sharded-update leaf ({biggest_leaf} B): "
                    f"the delta gather must stay per-leaf",
                ))
    elif policy == "per_param":
        if not gathers:
            findings.append(_finding(
                "ir-collective-budget", name,
                "FSDP-style strategy stepped with zero tensor-grade "
                "all-gathers: sharded params are never reassembled, the "
                "step cannot be computing with the whole weights",
            ))
        for op in gathers:
            if op.bytes >= total_param_bytes:
                findings.append(_finding(
                    "ir-collective-budget", name,
                    f"monolithic all-gather {op.describe()} >= total "
                    f"param bytes ({total_param_bytes} B): FSDP must "
                    f"gather per-param, not FlatParameter-style",
                ))
    return findings


# -- check 2: in-place update ---------------------------------------------
def inplace_findings(
    target: str, paths: Sequence[str], before: Sequence[int],
    after: Sequence[int],
) -> Tuple[Dict, List[Finding]]:
    """The in-place audit of one step: ``before`` and ``after`` are the
    ``data_ptr`` of the tensors named ``paths`` before and after it (in
    ``_named_step_tensors``' order). Returns (budget sub-entry,
    findings)."""
    findings: List[Finding] = []
    if len(after) != len(before):
        findings.append(_finding(
            "ir-donation-aliasing", target,
            f"the step changed its state's tensor count ({len(before)} -> "
            f"{len(after)}): state made inside the step is allocated anew "
            f"every step",
        ))
    realized = 0
    for path, b, a in zip(paths, before, after):
        if a == b:
            realized += 1
        else:
            findings.append(_finding(
                "ir-donation-aliasing", target,
                f"state tensor {path} left its address after the step "
                f"({b:#x} -> {a:#x}): the update is not in place, a "
                f"copy per step, and a captured step would go on reading "
                f"the old tensor",
            ))
    return {"donated": len(before), "realized": realized}, findings


def _named_ptrs(trainer, state, ring=None) -> Tuple[List[str], List[int]]:
    from pytorch_distributed_tpu_torch.pipeline_exec.runner import (
        _named_step_tensors,
    )

    named = _named_step_tensors(trainer, state)
    if ring is not None:
        named += [("ring.idx", ring.idx), ("ring.buf", ring.buf)]
    return [p for p, _ in named], [t.data_ptr() for _, t in named]


# -- check 3: program count (runner path) ---------------------------------
def runner_audit(
    program: StepProgram, submits: int = 3
) -> Tuple[Dict, Dict, List[Finding], List[float]]:
    """Drive ``submits`` steps of the program through an
    :class:`AsyncRunner` on its state (which the runner advances):
    (the step's in-place entry over its first step, the runner entry,
    findings, the steps' losses)."""
    from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

    name = program.name
    trainer = program.trainer
    findings: List[Finding] = []
    runner = AsyncRunner(trainer, depth=2, drain_every=submits)
    runner.start(program.state, program.batch)
    paths, ring_before = _named_ptrs(trainer, program.state, runner._ring)
    n_step = len(paths) - 2
    for i in range(submits):
        runner.submit(program.batch)
        if i == 0:
            _, first = _named_ptrs(trainer, program.state)
            step_entry, step_findings = inplace_findings(
                name, paths[:n_step], ring_before[:n_step], first)
            findings.extend(step_findings)
    entry = {
        "submits": submits,
        "dispatches": runner.dispatch_count,
        "executables": runner.executable_count,
        "programs_per_step": AsyncRunner.programs_per_step,
    }
    if runner.dispatch_count != submits:
        findings.append(_finding(
            "ir-program-count", name,
            f"{runner.dispatch_count} program dispatches for {submits} "
            f"submits: the step is not one program",
        ))
    if runner.executable_count != 1:
        findings.append(_finding(
            "ir-program-count", name,
            f"{runner.executable_count} Programs built behind the "
            f"pipelined step after {submits} same-shape submits: a "
            f"rebuild inside the steady-state loop",
        ))
    if AsyncRunner.programs_per_step != 1.0:
        findings.append(_finding(
            "ir-program-count", name,
            f"AsyncRunner.programs_per_step is "
            f"{AsyncRunner.programs_per_step}, expected 1.0",
        ))
    # the runner's own in-place contract: state AND metric ring
    _, ring_after = _named_ptrs(trainer, program.state, runner._ring)
    rentry, rfindings = inplace_findings(
        f"{name}[runner]", paths, ring_before, ring_after)
    entry["donation"] = rentry
    findings.extend(rfindings)
    state, hist = runner.finish()
    program.state = state
    return step_entry, entry, findings, [float(x) for x in hist["loss"]]


# -- check 4: sharding propagation ----------------------------------------
def _block(shape, dim: int, n: int) -> Tuple[int, ...]:
    out = list(shape)
    out[dim] //= n
    return tuple(out)


def sharding_findings(
    program: StepProgram,
) -> Tuple[Dict, List[Finding]]:
    from pytorch_distributed_tpu_torch.parallel import shard_spec_with_reason

    name = program.name
    strategy, trainer = program.strategy, program.trainer
    mesh = getattr(strategy, "mesh", None)
    findings: List[Finding] = []
    held = dict(trainer.model.named_parameters())
    stepped = ({leaf.name: leaf.tensor for leaf in trainer.layout.leaves}
               if trainer.layout is not None else held)
    opt_state = trainer.optimizer.state

    def size(axis):
        return mesh.size(axis) if (mesh is not None and axis) else 1

    declared_sharded = realized_sharded = 0
    want_param = want_opt = 0
    # (what, name, declared dim, its axis, held tensor, whole shape)
    leaves = []
    for pname, dim in program.declared["params"].items():
        leaves.append(("parameter", pname, dim, strategy.param_axis,
                       held[pname], program.shapes[pname]))
    for pname, keys in program.declared["opt_state"].items():
        st = opt_state.get(stepped[pname], {})
        for key, dim in keys.items():
            if key not in st:
                continue
            leaves.append(("optimizer state", f"{pname}.{key}", dim,
                           strategy.update_axis, st[key],
                           program.shapes[pname] if dim is not None
                           else tuple(st[key].shape)))
    for what, lname, dim, axis, tensor, whole in leaves:
        shape = tuple(tensor.shape)
        want = whole if dim is None else _block(whole, dim, size(axis))
        numel = 1
        for d in want:
            numel *= d
        if what == "parameter":
            want_param += numel * tensor.element_size()
        else:
            want_opt += numel * tensor.element_size()
        if dim is not None:
            declared_sharded += 1
            if shape == want:
                realized_sharded += 1
            else:
                findings.append(_finding(
                    "ir-sharding-propagation", name,
                    f"{what} {lname} declared sharded along dim {dim} "
                    f"(block {want}) but held as {shape}",
                ))
        elif shape != whole:
            realized_sharded += 1
    param_bytes = sum(p.numel() * p.element_size() for p in held.values())
    opt_bytes = sum(v.numel() * v.element_size() for st in opt_state.values()
                    for v in st.values() if hasattr(v, "numel"))
    for what, got, want in (("parameter", param_bytes, want_param),
                            ("optimizer", opt_bytes, want_opt)):
        if got != want:
            findings.append(_finding(
                "ir-sharding-propagation", name,
                f"this rank holds {got} B of {what} state, the declared "
                f"layout {want} B",
            ))
    entry: Dict = {
        "declared_sharded": declared_sharded,
        "realized_sharded": realized_sharded,
        "param_bytes": param_bytes,
        "opt_bytes": opt_bytes,
    }
    # replication fallbacks the strategy itself declared: named, counted,
    # and pinned by the budget so a silent loss of sharding is visible
    axis = getattr(strategy, "fsdp_axis", None) or getattr(
        strategy, "dp_axis", None
    )
    if axis is not None and hasattr(strategy, "min_shard_size"):
        counts: Dict[str, int] = {}
        for shape in program.shapes.values():
            _, reason = shard_spec_with_reason(
                shape, axis, mesh.size(axis), strategy.min_shard_size)
            counts[reason] = counts.get(reason, 0) + 1
        entry["fallbacks"] = dict(sorted(counts.items()))
    return entry, findings


# -- the audit of a program and of a grid ----------------------------------
def audit_program(
    program: StepProgram, *, runner_submits: int = 3
) -> ProgramAudit:
    """Every check over one program: the collectives its
    ``Trainer.step_artifacts`` recorded (no step run), the layout it
    holds, then ``runner_submits`` steps through the runner."""
    _, calls = program.trainer.step_artifacts(program.state, program.batch)
    ops = inv_mod.collective_inventory(calls)
    findings = collective_findings(program, ops)
    sharding_entry, sfindings = sharding_findings(program)
    findings.extend(sfindings)
    step_entry, runner_entry, rfindings, losses = runner_audit(
        program, submits=runner_submits)
    findings.extend(rfindings)
    entry = {
        "strategy": program.strategy_name,
        "amp": program.amp,
        "collectives": inv_mod.summarize_collectives(ops),
        "donation": step_entry,
        "sharding": sharding_entry,
        "runner": runner_entry,
    }
    return ProgramAudit(name=program.name, entry=entry, findings=findings,
                        losses=losses)


def run_audit(
    grid: str = "fast", *, runner_submits: int = 3,
    programs: Optional[List[StepProgram]] = None,
) -> AuditReport:
    """Audit the strategy x AMP grid of the port's own step programs on
    this rank (every rank of the process group calls it)."""
    from pytorch_distributed_tpu_torch import distributed as pdist

    if programs is None:
        programs = build_grid(grid)
    audits = [
        audit_program(p, runner_submits=runner_submits) for p in programs
    ]
    device = pdist.get_device()
    return AuditReport(
        grid=grid,
        platform="gpu" if device.type == "cuda" else device.type,
        device_count=pdist.get_world_size(),
        audits=audits,
    )
