"""The import check: whole top-level names, and no run loads JAX."""

import json
import subprocess
import sys

from portbench import guard, manifest


def test_top_level_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "pytorch_distributed_tpu", "pytorch_distributed_tpu.models",
             "pytorch_distributed_tpu_torch", "pytorch_distributed_tpu_torch.ops",
             "jaxtyping", "flaxen", "torch"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "pytorch_distributed_tpu", "pytorch_distributed_tpu.models"])


def test_a_run_loads_no_jax():
    """A whole small run of each one-chip cell, in a fresh process that
    has the harness, the port and the references loaded."""
    script = (
        "import json, sys\n"
        "from portbench import guard, run as R\n"
        "from portbench.tests.tiny import tiny_run\n"
        "out = {}\n"
        "for name in ('gpt2-125m.train', 'resnet50.train'):\n"
        "    out[name] = R.run_rank(tiny_run(name, seconds=0.1))['forbidden']\n"
        "import portbench.calibrate\n"
        "out['all'] = guard.forbidden_modules()\n"
        "out['port'] = 'pytorch_distributed_tpu_torch.trainer' in sys.modules\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"gpt2-125m.train": [], "resnet50.train": [], "all": [],
                   "port": True}


def test_no_card_means_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "resnet50.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(manifest.ROOT)})
    assert res.returncode != 0 and res.stdout == ""


def test_only_the_benchmark_cannot_run(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    fails without a result."""
    import shutil

    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "gpt2-125m.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
