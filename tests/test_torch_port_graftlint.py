"""The port's graftlint (``pytorch_distributed_tpu_torch.analysis``):
fixture tests (every torch rule fires on its bad example and stays quiet
on the good one), suppression semantics, JSON/baseline plumbing, config
parsing, cross-file resolution, the engine held against the reference's
on the same sources, and the gates that keep the port's tree (and its
paging files on their own) at zero findings, linted with torch made
unimportable.

Twins of ``tests/test_graftlint.py``; the reference package is imported
inside the tests that compare against it only.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from pytorch_distributed_tpu_torch.analysis import (
    all_rules,
    analyze_source,
    get_rules,
)
from pytorch_distributed_tpu_torch.analysis import baseline as baseline_mod
from pytorch_distributed_tpu_torch.analysis import config as config_mod
from pytorch_distributed_tpu_torch.analysis.cli import main as cli_main

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINTED = ["pytorch_distributed_tpu_torch/",
          "pytorch_distributed_tpu_torch/bench.py", "chip_smoke.py"]
TORCH_RULES = {
    "host-sync-in-hot-loop", "comm-staging", "uncoalesced-collective",
    "collective-axis-mismatch", "hand-rolled-reshard",
}

#: runs a module as ``python -m`` with torch, numpy, JAX and the JAX
#: package made unimportable: the lint tier needs the stdlib only
NO_TORCH = textwrap.dedent("""
    import importlib.abc, runpy, sys

    BLOCKED = ("torch", "numpy", "jax", "jaxlib", "flax", "optax",
               "pytorch_distributed_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    module, *argv = sys.argv[1:]
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__")
    finally:
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
""")


def run_lint(src, rules=None, require_justification=True):
    cfg = {"enable": list(rules)} if rules else {}
    return analyze_source(
        "fixture.py", textwrap.dedent(src), get_rules(cfg),
        require_justification=require_justification,
    )


def rule_names(result):
    return sorted({f.rule for f in result.findings})


# -- fixtures: each rule fires on bad, stays quiet on good -----------------

HOST_SYNC_BAD = """
    import torch

    def train_loop(model, batches):
        losses = []
        for b in batches:
            loss = torch.nn.functional.mse_loss(model(b), b)
            losses.append(loss.item())
        return losses
"""

HOST_SYNC_GOOD = """
    import torch

    def train_loop(model, batches):
        losses = []
        for b in batches:
            loss = torch.nn.functional.mse_loss(model(b), b)
            losses.append(loss.detach())
        return torch.stack(losses).tolist()
"""

HOST_SYNC_DEVICE_FN_BAD = """
    import torch
    import torch.nn.functional as F

    def attend(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def serve_steps(q, k, v, n):
        scores = []
        for _ in range(n):
            out = attend(q, k, v)
            scores.append(float(out.sum()))
        return scores
"""

HOST_SYNC_DEVICE_FN_GOOD = """
    import torch
    import torch.nn.functional as F

    def attend(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def serve_steps(q, k, v, n):
        scores = []
        for _ in range(n):
            out = attend(q, k, v)
            scores.append(out.sum())
        return torch.stack(scores).cpu().tolist()
"""

HOST_SYNC_WAIT_BAD = """
    import torch

    def decode_loop(engine, cache, n, stream):
        out = []
        for _ in range(n):
            out.append(engine.decode_step(cache))
            torch.cuda.synchronize()
            stream.synchronize()
        return out
"""

HOST_SYNC_WAIT_GOOD = """
    import torch

    def decode_loop(engine, cache, n):
        out = []
        for _ in range(n):
            out.append(engine.decode_step(cache))
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return out
"""

COMM_STAGING_BAD = """
    import torch
    import torch.distributed as dist

    def exchange_sizes(payload, group):
        return dist.all_reduce(torch.tensor([payload.numel()]), group=group)
"""

COMM_STAGING_GOOD = """
    import torch.distributed as dist

    def exchange_sizes(payload, size_buf, group):
        size_buf.fill_(payload.numel())
        dist.all_reduce(size_buf, group=group)
        return size_buf
"""

COMM_STAGING_PORT_BAD = """
    import numpy as np
    import torch
    from pytorch_distributed_tpu_torch.parallel import comm

    def share_lengths(lengths, group):
        comm.broadcast(torch.as_tensor([len(lengths)]), group)
        return comm.all_reduce(np.array(lengths), group)
"""

COMM_STAGING_PORT_GOOD = """
    import torch
    from pytorch_distributed_tpu_torch.parallel import comm

    def share_lengths(lengths, buf, group):
        buf.copy_(torch.as_tensor(lengths))
        return comm.all_reduce(buf, group)
"""

UNCOALESCED_BAD = """
    import torch.distributed as dist

    def sync_grads(model, group):
        for p in model.parameters():
            dist.all_reduce(p.grad, group=group)

    def bcast_state(model, group):
        return [dist.broadcast(t, 0, group=group)
                for t in model.state_dict().values()]
"""

UNCOALESCED_GOOD = """
    import torch
    import torch.distributed as dist
    from pytorch_distributed_tpu_torch.distributed.batch_ops import (
        coalescing_manager,
    )

    def sync_grads(model, group):
        grads = [p.grad for p in model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        return flat

    def logged(model):
        for p in model.parameters():
            print(p.shape)

    def other_tensor(model, staged, group):
        for p in model.parameters():
            dist.all_reduce(staged, group=group)

    def coalesced(model, group):
        with coalescing_manager(group) as cm:
            return [cm.all_reduce(p) for p in model.parameters()]
"""

AXIS_BAD = """
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.ops import collectives as C

    def reduce_loss(loss, n):
        mesh = init_device_mesh((n,), ("dp",))
        group = mesh.get_group("pd")
        return C.all_reduce(loss, mesh, "batch"), group
"""

AXIS_GOOD = """
    from pytorch_distributed_tpu_torch.mesh import init_device_mesh
    from pytorch_distributed_tpu_torch.ops import collectives as C

    def reduce_loss(loss, n, axis):
        mesh = init_device_mesh((n,), ("dp",))
        group = mesh.get_group("dp")
        size = mesh.size(("dp",))
        return (C.all_reduce(loss, mesh, "dp"), C.axis_size(mesh, axis),
                group, size, loss.size(0))
"""

RESHARD_BAD = """
    import torch
    import torch.distributed as dist
    from pytorch_distributed_tpu_torch.ops import collectives as C

    def gather_then_narrow(shard, group, n, lo, width):
        full = torch.empty((n * shard.shape[0], shard.shape[1]),
                           dtype=shard.dtype)
        dist.all_gather_into_tensor(full, shard, group=group)
        return full.narrow(1, lo, width)

    def gather_then_slice(x, mesh, lo, hi):
        g = C.all_gather(x, mesh, "tp", gather_dim=1)
        return g[:, lo:hi]
"""

RESHARD_GOOD = """
    import torch
    import torch.distributed as dist
    from pytorch_distributed_tpu_torch.redistribute import redistribute

    def reshard(x, dst):
        # the planner moves only the pieces each rank needs
        return redistribute(x, dst)

    def gather_only(shard, group, n):
        full = torch.empty((n * shard.shape[0], shard.shape[1]),
                           dtype=shard.dtype)
        dist.all_gather_into_tensor(full, shard, group=group)
        return full

    def slice_fresh(x, lo, width):
        return x.narrow(1, lo, width)
"""

RESHARD_LOOP_BAD = """
    import torch.distributed as dist

    def manual_fsdp_sync(model, group, n, rank):
        # FlatParameter-style per-param unshard/reshard, by hand
        for p in model.parameters():
            full = p.new_empty((n * p.shape[0], *p.shape[1:]))
            dist.all_gather_into_tensor(full, p.detach(), group=group)
            p.grad = full.chunk(n)[rank]
"""

RESHARD_LOOP_GOOD = """
    from pytorch_distributed_tpu_torch.parallel.fsdp import shard_module

    def slice_params(model, n, rank):
        # slicing parameters that were never gathered
        return [p.chunk(n)[rank] for p in model.parameters()]

    def sharded(model, strategy):
        # the sanctioned form: FSDP holds the parameters sharded
        return shard_module(model, strategy)
"""

FIXTURES = [
    ("host-sync-in-hot-loop", HOST_SYNC_BAD, HOST_SYNC_GOOD),
    ("host-sync-in-hot-loop", HOST_SYNC_DEVICE_FN_BAD,
     HOST_SYNC_DEVICE_FN_GOOD),
    ("host-sync-in-hot-loop", HOST_SYNC_WAIT_BAD, HOST_SYNC_WAIT_GOOD),
    ("comm-staging", COMM_STAGING_BAD, COMM_STAGING_GOOD),
    ("comm-staging", COMM_STAGING_PORT_BAD, COMM_STAGING_PORT_GOOD),
    ("uncoalesced-collective", UNCOALESCED_BAD, UNCOALESCED_GOOD),
    ("collective-axis-mismatch", AXIS_BAD, AXIS_GOOD),
    ("hand-rolled-reshard", RESHARD_BAD, RESHARD_GOOD),
    ("hand-rolled-reshard", RESHARD_LOOP_BAD, RESHARD_LOOP_GOOD),
]


@pytest.mark.parametrize(
    "rule,bad,good", FIXTURES,
    ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(FIXTURES)],
)
def test_rule_fires_on_bad_and_not_on_good(rule, bad, good):
    bad_result = run_lint(bad)
    assert rule in rule_names(bad_result), (
        f"{rule} did not fire on its bad fixture; "
        f"got {rule_names(bad_result)}"
    )
    good_result = run_lint(good)
    assert not good_result.findings, (
        f"false positives on the good fixture for {rule}: "
        f"{[f.render() for f in good_result.findings]}"
    )


def test_bad_fixtures_fire_once_per_site():
    """Each bad site is one finding: the loop's .item(), both waits, both
    staged arguments, both axis typos, both per-parameter collectives."""
    counts = {
        HOST_SYNC_BAD: 1, HOST_SYNC_WAIT_BAD: 2, COMM_STAGING_PORT_BAD: 2,
        AXIS_BAD: 2, UNCOALESCED_BAD: 2,
    }
    for src, n in counts.items():
        assert len(run_lint(src).findings) == n, src


def test_all_five_rules_registered():
    assert set(all_rules()) == TORCH_RULES


# -- precision (true stories from the port's own tree) ---------------------

def test_host_sync_device_step_methods_config():
    """``trainer.step(...)`` returns its metrics as tensors on the card;
    the device_step_methods key marks such methods card-returning so
    ``float(m["loss"])`` in the loop is caught."""
    src = """
        def train_epoch(trainer, state, batches):
            losses = []
            for b in batches:
                state, m = trainer.step(state, b)
                losses.append(float(m["loss"]))
            return state, losses
    """
    quiet = analyze_source(
        "fixture.py", textwrap.dedent(src),
        get_rules({"enable": ["host-sync-in-hot-loop"]}),
    )
    assert not quiet.findings
    loud = analyze_source(
        "fixture.py", textwrap.dedent(src),
        get_rules({"enable": ["host-sync-in-hot-loop"],
                   "device_step_methods": ["step"]}),
    )
    assert rule_names(loud) == ["host-sync-in-hot-loop"]


def test_host_sync_literal_tuple_unpack_stays_unknown():
    result = run_lint("""
        import torch

        def train_epoch(batches):
            out = []
            for b in batches:
                d, h = torch.mean(b), 3.0
                out.append(float(h))
            return out
    """)
    assert not result.findings


def test_host_sync_unknown_provenance_not_flagged():
    result = run_lint("""
        def decode_loop(batches):
            total = 0
            for b in batches:
                total += int(b["n_tokens"])
            return total
    """)
    assert not result.findings


def test_host_sync_metadata_and_host_tensors_not_flagged():
    """Shapes, sizes and dtypes answer on the host; a tensor made on the
    host without ``device=`` is a host tensor; ``.to("cpu")`` moves to the
    host, where ``.item()`` is no card sync."""
    result = run_lint("""
        import torch

        def train_loop(model, batches):
            rows = 0
            for b in batches:
                x = model(b.cuda())
                rows += int(x.shape[0]) + x.size(1) + x.numel()
                rows += torch.tensor([1, 2]).sum().item()
                rows += x.to("cpu").sum().item()
            return rows
    """)
    assert not result.findings


def test_host_sync_placement_gives_provenance():
    """``.cuda()``, ``.to(device)`` and ``device=`` put a value on the
    card, and a module built there returns card values."""
    result = run_lint("""
        import torch

        def train_loop(net_cls, batches, device):
            net = net_cls(device="cuda")
            seen = []
            for b in batches:
                y = net(b)
                z = torch.zeros(3, device=device)
                w = b.to(device)
                seen += [y.max().item(), z.tolist(), w.cpu()]
            return seen
    """)
    assert [f.message.split(" ")[0] for f in result.findings] == [
        ".item()", ".tolist()", ".cpu()"]


def test_reshard_allowed_path_exempts_planner_files():
    cfg = {"reshard_allowed_paths": ["pkg/redistribute"]}
    src = textwrap.dedent(RESHARD_BAD)
    inside = analyze_source(
        "pkg/redistribute/executor.py", src,
        get_rules(dict(cfg, enable=["hand-rolled-reshard"])))
    assert not inside.findings
    outside = analyze_source(
        "pkg/serving/engine.py", src,
        get_rules(dict(cfg, enable=["hand-rolled-reshard"])))
    assert "hand-rolled-reshard" in rule_names(outside)


def test_reshard_suppression_with_justification():
    result = run_lint("""
        import torch.distributed as dist

        def first_placement(full, shard, group, lo):
            dist.all_gather_into_tensor(full, shard, group=group)
            # graftlint: disable-next-line=hand-rolled-reshard -- a one-off debug dump, never on a step path
            return full[lo:]
    """)
    assert not result.findings
    assert len(result.suppressed) == 1


# -- suppressions ----------------------------------------------------------

def test_same_line_suppression_with_justification():
    result = run_lint("""
        import torch

        def train_loop(batches):
            for b in batches:
                loss = torch.mean(b)
                print(loss.item())  # graftlint: disable=host-sync-in-hot-loop -- debug epoch log
    """)
    assert not result.findings
    assert len(result.suppressed) == 1


def test_next_line_suppression():
    result = run_lint("""
        import torch

        def train_loop(batches):
            for b in batches:
                loss = torch.mean(b)
                # graftlint: disable-next-line=host-sync-in-hot-loop -- debug epoch log
                print(loss.item())
    """)
    assert not result.findings
    assert len(result.suppressed) == 1


def test_unjustified_suppression_is_itself_a_finding():
    result = run_lint("""
        import torch

        def train_loop(batches):
            for b in batches:
                loss = torch.mean(b)
                print(loss.item())  # graftlint: disable=host-sync-in-hot-loop
    """)
    assert rule_names(result) == ["unjustified-suppression"]
    assert len(result.suppressed) == 1


def test_unused_suppression_is_reported():
    result = run_lint("""
        def quiet():
            # graftlint: disable-next-line=host-sync-in-hot-loop -- nothing here
            return 1
    """)
    assert rule_names(result) == ["unused-suppression"]


def test_directive_inside_docstring_is_documentation():
    result = run_lint('''
        def helper():
            """Example: x.item()  # graftlint: disable=host-sync-in-hot-loop -- why"""
            return 1
    ''')
    assert not result.findings


def test_no_justification_check_flag():
    result = run_lint("""
        import torch

        def train_loop(batches):
            for b in batches:
                loss = torch.mean(b)
                print(loss.item())  # graftlint: disable=host-sync-in-hot-loop
    """, require_justification=False)
    assert not result.findings


# -- reporters / baseline / CLI --------------------------------------------

def test_json_output_shape(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(COMM_STAGING_BAD))
    rc = cli_main([str(bad), "--format", "json", "--no-config"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["version"] == 1
    assert payload["summary"]["findings"] == len(payload["findings"]) == 1
    (finding,) = payload["findings"]
    assert finding["rule"] == "comm-staging"
    assert finding["line"] > 0
    assert set(payload["summary"]["rules_run"]) == TORCH_RULES


def test_baseline_round_trip(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(COMM_STAGING_BAD))
    base = tmp_path / "base.json"

    rc = cli_main([str(bad), "--write-baseline", str(base), "--no-config"])
    assert rc == 0
    capsys.readouterr()

    rc = cli_main([str(bad), "--baseline", str(base), "--no-config"])
    assert rc == 0
    capsys.readouterr()

    # a NEW finding still fails, and line moves don't resurrect the
    # baselined one (fingerprints are line-insensitive)
    bad.write_text(
        "\n\n" + textwrap.dedent(COMM_STAGING_BAD) + textwrap.dedent("""
        def broadcast_size(n, group):
            import torch
            import torch.distributed as dist
            return dist.broadcast(torch.tensor([n]), 0, group=group)
        """)
    )
    rc = cli_main(
        [str(bad), "--baseline", str(base), "--format", "json",
         "--no-config"]
    )
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["summary"]["findings"] == 1
    assert payload["summary"]["baselined"] == 1
    assert payload["findings"][0]["symbol"].endswith("broadcast_size")


def test_baseline_rejects_unknown_version(tmp_path):
    base = tmp_path / "base.json"
    base.write_text('{"version": 99, "fingerprints": []}')
    with pytest.raises(ValueError):
        baseline_mod.load_baseline(str(base))


def test_cli_unknown_rule_is_config_error(tmp_path, capsys):
    src = tmp_path / "x.py"
    src.write_text("x = 1\n")
    # a JAX-only rule is unknown to the port
    rc = cli_main([str(src), "--rules", "recompile-hazard", "--no-config"])
    capsys.readouterr()
    assert rc == 2


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in TORCH_RULES)


def test_parse_error_is_reported(tmp_path, capsys):
    src = tmp_path / "broken.py"
    src.write_text("def f(:\n")
    rc = cli_main([str(src), "--format", "json", "--no-config"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["findings"][0]["rule"] == "parse-error"


# -- config ----------------------------------------------------------------

def test_config_block_parses(tmp_path):
    py = tmp_path / "pyproject.toml"
    py.write_text(textwrap.dedent("""
        [tool.graftlint]
        enable = ["recompile-hazard"]

        [tool.graftlint-torch]
        enable = [
            "comm-staging",
            "hand-rolled-reshard",
        ]
        exclude = ["examples"]
        known_axes = ["dp", "tp"]

        [tool.after]
        y = 2
    """))
    cfg = config_mod.load_config(str(py))
    assert cfg["enable"] == ["comm-staging", "hand-rolled-reshard"]
    assert cfg["known_axes"] == ["dp", "tp"]
    # the repo defaults fill the keys the table leaves out
    assert cfg["device_step_methods"] == ["step"]
    assert "examples" in config_mod.effective_excludes(cfg)
    assert [r.name for r in get_rules(cfg)] == [
        "comm-staging", "hand-rolled-reshard"
    ]


def test_config_unknown_key_fails_loudly(tmp_path):
    py = tmp_path / "pyproject.toml"
    py.write_text("[tool.graftlint-torch]\nenbale = [\"comm-staging\"]\n")
    with pytest.raises(ValueError, match="enbale"):
        config_mod.load_config(str(py))


def test_repo_config_enables_all_rules():
    """The repo's pyproject has no port table: the port's defaults are
    its configuration, and ``[tool.graftlint]`` (the JAX rules) is never
    read."""
    cfg = config_mod.load_config(os.path.join(REPO_ROOT, "pyproject.toml"))
    assert cfg == config_mod.REPO_DEFAULTS
    assert {r.name for r in get_rules(cfg)} == TORCH_RULES
    assert set(cfg) <= config_mod.KNOWN_KEYS


# -- cross-file resolution (the project index) ------------------------------

LINT_LIB = """
    import torch.nn.functional as F

    def attend(q, k, v):
        return F.scaled_dot_product_attention(q, k, v)

    def shape_of(x):
        return x.shape
"""

LINT_APP = """
    from pkg.lib import attend, shape_of
    import pkg.lib as plib

    def serve_steps(q, k, v, n):
        out = []
        for _ in range(n):
            y = attend(q, k, v)
            out.append(y.max().item())       # card value -> finding
        return out

    def train_steps(q, k, v, n):
        out = []
        for _ in range(n):
            out.append(plib.attend(q, k, v).tolist())   # module-attr
        return out

    def decode_steps(q, n):
        out = []
        for _ in range(n):
            out.append(int(shape_of(q)[0]))  # host metadata: clean
        return out
"""


def _analyze_pkg(tmp_path, monkeypatch, files):
    from pytorch_distributed_tpu_torch.analysis.core import analyze_paths

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name, src in files.items():
        (pkg / name).write_text(textwrap.dedent(src))
    monkeypatch.chdir(tmp_path)
    return analyze_paths(["pkg"], get_rules())


def test_module_name_for_path():
    from pytorch_distributed_tpu_torch.analysis.core import (
        module_name_for_path,
    )

    assert module_name_for_path("a/b/c.py") == "a.b.c"
    assert module_name_for_path("a/b/__init__.py") == "a.b"


def test_cross_file_device_function_is_found(tmp_path, monkeypatch):
    """A function of one module that returns a card value makes its
    callers' results card values through a from-import and a module-attr
    spelling; a function returning host metadata does not."""
    res = _analyze_pkg(tmp_path, monkeypatch,
                       {"lib.py": LINT_LIB, "app.py": LINT_APP})
    symbols = {f.symbol for f in res.findings}
    assert symbols == {"serve_steps", "train_steps"}, (
        [f.render() for f in res.findings])
    assert all(f.rule == "host-sync-in-hot-loop" for f in res.findings)


def test_single_file_analysis_has_no_project_index():
    """analyze_source (single file, no index) must not fire on imported
    functions it cannot see: cross-file resolution is analyze_paths-only."""
    result = run_lint(LINT_APP)
    assert not result.findings


def _imports(src, path):
    from pytorch_distributed_tpu_torch.analysis.core import Module

    source = textwrap.dedent(src)
    return Module(path, source, ast.parse(source)).imports


def test_relative_imports_canonicalize_to_absolute():
    imp = _imports("from .lib import attend\n", "pkg/app.py")
    assert imp["attend"] == "pkg.lib.attend"
    imp = _imports("from . import lib\n", "pkg/app.py")
    assert imp["lib"] == "pkg.lib"
    imp = _imports("from ..core import thing\n", "pkg/sub/mod.py")
    assert imp["thing"] == "pkg.core.thing"
    imp = _imports("from .sibling import f\n", "pkg/__init__.py")
    assert imp["f"] == "pkg.sibling.f"
    imp = _imports("from .lib import attend as at\n", "pkg/app.py")
    assert imp["at"] == "pkg.lib.attend"


def test_relative_import_past_root_stays_unresolved():
    imp = _imports("from ...mystery import f\n", "pkg/app.py")
    assert "f" not in imp


def test_aliased_module_import_spellings():
    imp = _imports("import pkg.lib as plib\n", "pkg/app.py")
    assert imp["plib"] == "pkg.lib"
    imp = _imports("import pkg.lib\n", "other/app.py")
    assert imp["pkg"] == "pkg"


def test_resolve_canonicalizes_torch_spellings():
    from pytorch_distributed_tpu_torch.analysis.core import Module

    src = textwrap.dedent("""
        import torch.distributed as td
        import torch.nn.functional as fn
        import numpy
        td.all_reduce
        fn.relu
        numpy.asarray
    """)
    mod = Module("m.py", src, ast.parse(src))
    exprs = [n.value for n in mod.tree.body if isinstance(n, ast.Expr)]
    assert [mod.resolve(e) for e in exprs] == [
        "dist.all_reduce", "F.relu", "np.asarray"]


LINT_APP_RELATIVE = """
    from .lib import attend as at
    from . import lib

    def serve_steps(q, k, v, n):
        out = []
        for _ in range(n):
            out.append(at(q, k, v).item())
        return out

    def decode_steps(q, k, v, n):
        out = []
        for _ in range(n):
            out.append(lib.attend(q, k, v).item())
        return out
"""


def test_cross_file_resolution_through_relative_imports(
    tmp_path, monkeypatch
):
    res = _analyze_pkg(tmp_path, monkeypatch,
                       {"lib.py": LINT_LIB, "app.py": LINT_APP_RELATIVE})
    symbols = {f.symbol for f in res.findings}
    assert symbols == {"serve_steps", "decode_steps"}, (
        [f.render() for f in res.findings])


# -- --changed-only --------------------------------------------------------

def test_only_files_filters_rule_pass_but_keeps_index(
    tmp_path, monkeypatch
):
    from pytorch_distributed_tpu_torch.analysis.core import analyze_paths

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "lib.py").write_text(textwrap.dedent(LINT_LIB))
    (pkg / "app.py").write_text(textwrap.dedent(LINT_APP))
    monkeypatch.chdir(tmp_path)

    res = analyze_paths(["pkg"], get_rules(),
                        only_files=[str(pkg / "app.py")])
    assert res.files == 1
    assert any(f.rule == "host-sync-in-hot-loop" for f in res.findings), (
        [f.render() for f in res.findings]
    )
    res = analyze_paths(["pkg"], get_rules(),
                        only_files=[str(pkg / "lib.py")])
    assert res.files == 1
    assert not res.findings


def test_changed_only_falls_back_outside_git(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(COMM_STAGING_BAD))
    monkeypatch.chdir(tmp_path)
    rc = cli_main([str(bad), "--changed-only", "--no-config"])
    captured = capsys.readouterr()
    assert "not a git work tree" in captured.err
    assert rc == 1


def _git(cwd, *args):
    subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=cwd, check=True, capture_output=True,
    )


def test_changed_only_analyzes_only_changed_and_untracked(tmp_path):
    committed = tmp_path / "committed_bad.py"
    committed.write_text(textwrap.dedent(COMM_STAGING_BAD))
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "committed_bad.py")
    _git(tmp_path, "commit", "-qm", "seed")
    untracked = tmp_path / "untracked_bad.py"
    untracked.write_text(textwrap.dedent(COMM_STAGING_BAD))

    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.analysis",
         ".", "--changed-only", "--no-config", "--format", "json"],
        capture_output=True, text=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": REPO_ROOT},
    )
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    paths = {f["path"] for f in payload["findings"]}
    assert paths == {"untracked_bad.py"}, payload
    assert payload["summary"]["files"] == 1


# -- the engine against the reference's, on the same sources ----------------

ENGINE_SOURCES = {
    "suppressions": textwrap.dedent("""
        x = 1  # graftlint: disable=host-sync-in-hot-loop -- a reason
        # graftlint: disable-next-line=a-rule,b-rule -- two rules
        y = 2
        z = 3  # graftlint: disable
        w = 4  # graftlint: disable=c-rule
        def f():
            \"\"\"x  # graftlint: disable=d-rule -- in a docstring\"\"\"
    """),
    "broken": "def f(:\n    x = 1  # graftlint: disable=e-rule -- why\n",
    "imports": textwrap.dedent("""
        import os
        import torch.distributed as dist
        import pkg.lib
        import pkg.lib as plib
        from pkg.lib import attend, shape_of as so
        from . import sibling
        from .lib import attend as at
        from ..core import thing
        from ...past import nothing
        from __future__ import annotations
    """),
}
ENGINE_PATHS = ["pkg/app.py", "pkg/sub/mod.py", "pkg/__init__.py", "app.py",
                "a/b/c.py", "a/b/__init__.py", "/a/b.py"]


@pytest.mark.parametrize("name", ["suppressions", "broken"])
def test_suppression_parsing_equals_the_reference(name):
    from pytorch_distributed_tpu.analysis import core as ref
    from pytorch_distributed_tpu_torch.analysis import core as port

    src = ENGINE_SOURCES[name]
    got = {k: vars(v) for k, v in port._parse_suppressions(src).items()}
    want = {k: vars(v) for k, v in ref._parse_suppressions(src).items()}
    assert got == want and got


@pytest.mark.parametrize("path", ENGINE_PATHS)
def test_module_names_and_imports_equal_the_reference(path):
    from pytorch_distributed_tpu.analysis import core as ref
    from pytorch_distributed_tpu_torch.analysis import core as port

    assert port.module_name_for_path(path) == ref.module_name_for_path(path)
    src = ENGINE_SOURCES["imports"]
    tree = ast.parse(src)
    got = port.Module(path, src, tree)
    want = ref.Module(path, src, tree)
    assert got.imports == want.imports
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.alias)]
    assert calls
    node = ast.parse("plib.attend.x").body[0].value
    assert got.dotted(node) == want.dotted(node) == "plib.attend.x"
    assert got.resolve(node) == want.resolve(node) == "pkg.lib.attend.x"


def test_findings_and_json_equal_the_reference():
    from pytorch_distributed_tpu.analysis import core as ref
    from pytorch_distributed_tpu.analysis import reporter as ref_reporter
    from pytorch_distributed_tpu_torch.analysis import core as port
    from pytorch_distributed_tpu_torch.analysis import reporter

    fields = dict(rule="comm-staging", path="pkg/a.py", line=3, col=5,
                  message="m", symbol="f.g")
    a, b = port.Finding(**fields), ref.Finding(**fields)
    assert a.fingerprint() == b.fingerprint()
    assert a.render() == b.render() and a.to_dict() == b.to_dict()
    kw = dict(files=2, suppressed=1, baselined=0, rules=["comm-staging"])
    got = json.loads(reporter.render_json([a], **kw))
    want = json.loads(ref_reporter.render_json([b], **kw))
    assert got == want
    assert (reporter.render_text([a], files=2)
            == ref_reporter.render_text([b], files=2))


def test_baselines_cross_read_with_the_reference(tmp_path):
    from pytorch_distributed_tpu.analysis import baseline as ref_baseline
    from pytorch_distributed_tpu.analysis import core as ref
    from pytorch_distributed_tpu_torch.analysis import core as port

    fields = [dict(rule="comm-staging", path="a.py", line=i, col=1,
                   message=f"m{i % 2}", symbol="f") for i in range(3)]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    baseline_mod.write_baseline(str(ours),
                                [port.Finding(**f) for f in fields])
    ref_baseline.write_baseline(str(theirs),
                                [ref.Finding(**f) for f in fields])
    assert ours.read_text() == theirs.read_text()
    fresh, old = ref_baseline.apply_baseline(
        [ref.Finding(**fields[0])], ref_baseline.load_baseline(str(ours)))
    assert not fresh and len(old) == 1
    fresh, old = baseline_mod.apply_baseline(
        [port.Finding(**dict(fields[0], message="new"))],
        baseline_mod.load_baseline(str(theirs)))
    assert len(fresh) == 1 and not old


# -- the catalogue ----------------------------------------------------------

def test_rules_md_documents_every_rule_and_check():
    from pytorch_distributed_tpu_torch.analysis.ir.audit import CHECKS

    path = os.path.join(REPO_ROOT, "pytorch_distributed_tpu_torch",
                        "analysis", "RULES.md")
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    for name in sorted(TORCH_RULES):
        assert f"\n## {name}\n" in text, name
    for name in sorted(CHECKS):
        assert f"\n### {name}\n" in text, name


# -- the gates -------------------------------------------------------------

def _lint_without_torch(*argv, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-c", NO_TORCH,
         "pytorch_distributed_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=cwd,
        env={**os.environ, "PYTHONPATH": REPO_ROOT},
    )


def test_lint_tier_runs_without_torch(tmp_path):
    """The lint tier imports the stdlib only and never the code it
    lints: with torch, numpy and JAX unimportable it lints a bad file
    (exit 1, its finding) and lists its rules."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(COMM_STAGING_BAD))
    proc = _lint_without_torch(str(bad), "--format", "json", "--no-config")
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout)["findings"][0]["rule"] == "comm-staging"
    proc = _lint_without_torch("--list-rules")
    assert proc.returncode == 0, proc.stderr
    assert all(rule in proc.stdout for rule in TORCH_RULES)


def test_paging_subsystem_is_gated():
    """The paged-cache tree and its kernel wrapper lint clean on their
    own, with no suppression."""
    proc = _lint_without_torch(
        "pytorch_distributed_tpu_torch/serving/paging/",
        "pytorch_distributed_tpu_torch/ops/paged_attention.py",
        "--format", "json")
    assert proc.returncode == 0, (
        f"paging files have findings:\n{proc.stdout}\n{proc.stderr}"
    )
    payload = json.loads(proc.stdout)
    assert payload["summary"]["findings"] == 0
    assert payload["summary"]["suppressed"] == 0
    assert payload["summary"]["files"] >= 5


def test_repo_is_clean():
    """The port's package, its bench and chip_smoke.py lint clean, with
    torch unimportable: zero unsuppressed findings, the five rules run,
    and (unjustified-suppression being a finding itself) every
    suppression carries its reason."""
    proc = _lint_without_torch(*LINTED, "--format", "json")
    assert proc.returncode == 0, (
        f"graftlint found regressions:\n{proc.stdout}\n{proc.stderr}"
    )
    payload = json.loads(proc.stdout)
    assert payload["summary"]["findings"] == 0
    assert set(payload["summary"]["rules_run"]) == TORCH_RULES
