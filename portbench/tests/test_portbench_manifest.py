"""BENCHMARK.json against the contract's form, and the files it names."""

import json
import os
import shutil
import subprocess
import sys

from portbench import manifest

MF = manifest.load()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = ("n_embd", "n_head", "hidden", "intermediate", "width", "_dim", "_rank")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(MF) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    for kind, keys in KEYS.items():
        for entry in MF[kind]:
            extra = set(entry) - keys - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            assert not extra and keys <= set(entry), (kind, entry["name"])
    assert len(json.dumps(MF)) < 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in KEYS for e in MF[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert manifest.NAME.fullmatch(n), n
    for w in MF["workloads"]:
        assert manifest.NAME.fullmatch(w["traffic"]) and _line(w["why"])
    for c in MF["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert manifest.NAME.fullmatch(key)
            assert not any(part in key for part in WIDTHS), key
    for m in MF["end_to_end"] + MF["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MF["per_layer"]:
        assert _line(m["layer"])
    for word in MF["command"]:
        assert _line(word)


def test_paths_commands_and_file_names():
    assert MF["paths"] == ["portbench"]
    assert not any(w.startswith("/") or ".." in w for w in MF["command"])
    for path in (manifest.ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_bounds_and_budget():
    for m in MF["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in MF["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    s = MF["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in MF["workloads"])
    assert four <= max(1, len(MF["workloads"]) // 4)


def test_every_cell_finds_its_files_and_metrics():
    e2e = {m["name"]: m for m in MF["end_to_end"]}
    for w in MF["workloads"]:
        cell = manifest.cell_file(w["name"])
        assert cell["config"] == w["config"]
        manifest.config_file(MF, w["config"])
        drv = manifest.driver(cell["driver"])
        reports = {m["name"] for m in manifest.metrics_of(MF, "end_to_end", w["name"])}
        assert "setup_s" in reports and len(reports) >= 2
        assert f"{drv.WORK}_per_s" in reports
        per_layer = manifest.metrics_of(MF, "per_layer", w["name"])
        assert per_layer
        for m in per_layer:
            assert m["moves"] in reports, (w["name"], m["name"])
    for m in MF["per_layer"]:
        reader = manifest.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])
        assert m["moves"] in e2e


def test_configs_hold_their_source_and_cuts():
    for c in MF["configs"]:
        cfg = manifest.config_file(MF, c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg


def test_a_new_cell_is_found_by_name(tmp_path):
    """A configuration, a cell, a per-layer metric and a kernel family added
    as new files (and manifest entries) run with no file changed."""
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mf = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((manifest.HERE / "configs" / "gpt2-125m.json").read_text())
    cfg.update(vocab_size=128, n_positions=16, n_embd=32, n_layer=1, n_head=2)
    (tmp_path / "portbench/configs/gpt2-toy.json").write_text(json.dumps(cfg))
    cell = json.loads((manifest.HERE / "cells/gpt2-125m.train.json").read_text())
    cell.update(config="gpt2-toy", batch=2, seq_len=16, distinct_batches=2,
                traced_steps=2)
    (tmp_path / "portbench/cells/gpt2-toy.train.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/kernels/toyops.json").write_text(
        json.dumps({"why": "a test family", "patterns": ["^aten::mm$"]}))
    (tmp_path / "portbench/metrics/host_ops.toy.py").write_text(
        "LAYER = 'host'\nUNIT = 'ops'\nMOVES = 'tokens_per_s'\n"
        "def read(ctx):\n    return float(len(ctx['trace'].host_ops))\n")
    mf["configs"].append(dict(mf["configs"][0], name="gpt2-toy",
                              file="portbench/configs/gpt2-toy.json"))
    mf["workloads"].append({"name": "gpt2-toy.train", "config": "gpt2-toy",
                            "traffic": "train", "chips": 1, "why": "a test"})
    mf["per_layer"].append({"name": "host_ops.toy", "unit": "ops",
                            "better": "lower", "source": "program_counter",
                            "layer": "host", "moves": "tokens_per_s",
                            "workloads": ["gpt2-toy.train"]})
    for m in mf["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append("gpt2-toy.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(mf))
    script = (
        "import json, torch\n"
        "from portbench import manifest, run as R\n"
        "assert 'toyops' in manifest.kernel_families()\n"
        "mf, wl, cell, cfg = R.load_cell('gpt2-toy.train')\n"
        "run = R.Run(mf, wl, cell, cfg, 7, 0.2, True, torch.device('cpu'))\n"
        "part = R.run_rank(run)\n"
        "print(json.dumps([part['steps'], part['per_layer']]))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{manifest.ROOT}")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    steps, per_layer = json.loads(out.stdout.strip().splitlines()[-1])
    assert steps >= 1 and per_layer["host_ops.toy"] > 0
    assert set(per_layer) == {"host_ops.toy"}   # no device ops on the CPU
