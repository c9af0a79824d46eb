"""Tensor-parallel serving in the port against the JAX package, on the CPU.

Mirrors ``tests/test_serving.py``'s TP serving and train -> serve cases:
the placements of ``gpt2_param_shardings`` (the Megatron plan on tp only)
and of both cache shardings (heads on tp); greedy streams on 4 gloo ranks
(``tests/_torch_port_ranks.py``, spawned once for the file; rank bodies
in ``tests/_torch_port_tp.py``) at ``(dp 2, tp 2)`` and ``(dp 1, tp 4)``,
on the slotted and the paged cache, with and without ``spec_k 3`` (a
one-layer self-draft), equal to the JAX engine's token for token on the
weights flax drew (GPT-2 with 2 layers, width 48, 4 heads, vocab 97; 5
requests over 3 slots). Every rank, dp replicas included, emits the same
streams, and the engine runs its bodies eagerly (no card).

``load_gpt2_params`` reads a checkpoint that the port's
``train_gpt2.py --ckpt-dir`` wrote onto 2 tp ranks: the gathered weights
equal the checkpoint's, and only ``model/...`` entries are read off disk
(``FileSystemReader.read_data`` recorded). ``serve_gpt2.py --tp 2
--ckpt-dir`` runs on 2 CPU ranks under ``elastic.run``, rank 0 printing.
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    draft_param_shardings,
    gpt2_param_shardings,
    kv_cache_sharding,
    paged_kv_cache_sharding,
    reshard_gpt2_params,
    shard_gpt2_params,
)
from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp as tph
from tests._torch_port_tp import StubMesh

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CASES = [(tp, kind, k) for tp in (2, 4) for kind in ("slotted", "paged")
         for k in (0, 3)]
TRAIN = ["--layers", "2", "--embd", "48", "--heads", "4", "--vocab", "97",
         "--seq-len", "32", "--device", "cpu"]


def test_param_shardings():
    mesh = StubMesh((2, 4), ("dp", "tp"))
    model = GPT2(GPT2Config(**tph.SERVE), device="cpu")
    place = gpt2_param_shardings(model, mesh)
    assert place["h.0.attn.c_attn.weight"] == {"tp": 0}
    assert place["h.0.attn.c_proj.weight"] == {"tp": 1}
    assert place["h.1.mlp.c_fc.bias"] == {"tp": 0}
    assert place["h.1.mlp.c_proj.bias"] == {}
    assert place["wte"] == {"tp": 1} and place["ln_f.weight"] == {}
    # dp replicates: no parameter shards over it
    assert all("dp" not in p for p in place.values())
    draft = GPT2(GPT2Config(**{**tph.SERVE, "n_layer": 1}), device="cpu")
    assert draft_param_shardings(draft, mesh) == {
        n: p for n, p in place.items() if not n.startswith("h.1.")}


def test_cache_shardings():
    mesh = StubMesh((2, 4), ("dp", "tp"))
    assert kv_cache_sharding(mesh).dims == {3: "tp"}    # [L, S, T, H, D]
    assert kv_cache_sharding(mesh, dp_axis="dp").dims == {3: "tp", 1: "dp"}
    assert paged_kv_cache_sharding(mesh).dims == {3: "tp"}
    assert kv_cache_sharding(mesh).tp_axis == "tp"


def test_engine_checks_the_models_cut():
    model = GPT2(GPT2Config(**tph.SERVE), device="cpu")
    mesh = StubMesh((1, 2), ("dp", "tp"))
    with pytest.raises(ValueError, match="shard_gpt2_params"):
        InferenceEngine(model, device="cpu",
                        cache_sharding=kv_cache_sharding(mesh))
    with pytest.raises(NotImplementedError, match="A.15d"):
        InferenceEngine(model, device="cpu",
                        cache_sharding=kv_cache_sharding(mesh,
                                                         dp_axis="dp"))
    assert not InferenceEngine(model, device="cpu").graphs


def test_reshard_raises_naming_a16():
    """A.16 is ported: ``reshard_gpt2_params`` moves a state dict on the
    host onto a tp rank's serving blocks (each rank narrows its own, no
    collective), the blocks ``shard_gpt2_params`` cuts, c_attn's per-head
    rows of q, k and v included."""
    model = GPT2(GPT2Config(**tph.SERVE), device="cpu")
    whole = {n: t.clone() for n, t in model.state_dict().items()}
    for r in range(2):
        mesh = StubMesh((1, 2), ("dp", "tp"), coords={"dp": 0, "tp": r})
        blocks = reshard_gpt2_params(whole, mesh)
        cut = GPT2(GPT2Config(**tph.SERVE), device="cpu")
        cut.load_state_dict(whole)
        shard_gpt2_params(cut, mesh)
        want = cut.state_dict()
        assert set(blocks) == set(want)
        for name, t in want.items():
            assert torch.equal(blocks[name], t), (r, name)
        assert blocks["h.0.attn.c_attn.weight"].shape == (72, 48)


def jax_streams(variables):
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler

    jmodel = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.SERVE))
    out = {}
    for kind in ("slotted", "paged"):
        for k in (0, 3):
            kw = dict(n_slots=3, max_len=40, prefill_len=16)
            if kind == "paged":
                kw.update(cache_kind="paged", page_size=4)
            if k:
                kw.update(spec_k=k, draft_layers=1)
            sched = JaxScheduler(JaxEngine(jmodel, variables, **kw),
                                 emit_events=False)
            for prompt, n_new in tph.serve_requests():
                sched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
            out[(kind, k)] = {f.request_id: list(f.tokens)
                              for f in sched.run()}
    return out


def _serve_both(rank, store_dir, state_dict):
    for tp in (2, 4):
        tph.serve_body(rank, store_dir, tp, state_dict)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu_torch.models import gpt2_state_dict_from_flax

    tmp = tmp_path_factory.mktemp("serve")
    variables = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.SERVE)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    sd = gpt2_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    ctx = ranks.start(_serve_both, tmp, sd)
    want = jax_streams(variables)
    ranks.finish(ctx, timeout=240)
    got = {tp: [torch.load(f"{tmp}/serve{tp}.rank{r}.pt", weights_only=False)
                for r in range(ranks.WORLD)] for tp in (2, 4)}
    return got, want


@pytest.mark.parametrize("tp,kind,spec_k", CASES)
def test_tp_streams_equal_the_jax_engines(served, tp, kind, spec_k):
    got, want = served
    for rank, out in enumerate(got[tp]):
        streams, graphs = out[(kind, spec_k)]
        assert streams == want[(kind, spec_k)], rank
        assert not graphs


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_holds_its_heads(served, tp):
    got, _ = served
    C, L = tph.SERVE["n_embd"], tph.SERVE["n_layer"]
    for out in got[tp]:
        held = out["held"]
        assert held["h.0.attn.c_attn.weight"] == (3 * C // tp, C)
        assert held["h.0.attn.c_proj.weight"] == (C, C // tp)
        assert held["wte"] == (tph.SERVE["vocab_size"], C // tp)
        assert held["h.0.ln_1.weight"] == (C,)
        assert len(held) == 4 + 12 * L


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    d = tmp / "run"
    ctx = ranks.start(tph.train_ckpt_body, tmp, TRAIN + [
        "--global-batch", "4", "--steps", "3", "--dataset-size", "16",
        "--ckpt-every", "2", "--ckpt-dir", str(d)], world=1)
    ranks.finish(ctx)
    assert len(torch.load(tmp / "train_losses.pt")) == 3
    return d


def test_load_gpt2_params_onto_tp_ranks(ckpt, tmp_path):
    from pytorch_distributed_tpu_torch.checkpoint import load_params

    cfg = dict(vocab_size=97, n_positions=32, n_embd=48, n_layer=2,
               n_head=4)
    want = GPT2(GPT2Config(**cfg), device="cpu", seed=7)
    assert load_params(str(ckpt), want) == 3
    ctx = ranks.start(tph.load_body, tmp_path, str(ckpt), cfg, world=2)
    ranks.finish(ctx)
    for rank in range(2):
        out = torch.load(tmp_path / f"load.rank{rank}.pt", weights_only=False)
        assert out["step"] == 3
        assert out["held"]["h.1.attn.c_attn.weight"] == (72, 48)
        for name, p in want.state_dict().items():
            assert torch.equal(out["params"][name], p), name
        assert out["read"] and all(k.startswith("model/")
                                   for k in out["read"]), out["read"]


def test_serve_example_tp2_from_checkpoint_under_elastic_run(ckpt, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.elastic.run",
         "--standalone", "--nproc-per-node", "2", "--max-restarts", "0",
         "--log-dir", str(logs), "-m",
         "pytorch_distributed_tpu_torch.examples.serve_gpt2", *TRAIN,
         "--tp", "2", "--ckpt-dir", str(ckpt), "--slots", "2",
         "--prefill-len", "8", "--requests", "3", "--max-new-tokens", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    worker = {int(re.search(r"worker_(\d+)", str(p)).group(1)): p.read_text()
              for p in logs.rglob("worker_*.log")}
    assert set(worker) == {0, 1}
    out = worker[0]
    assert "loaded params from" in out and "step 3, tp=2" in out
    assert "serving mesh {'dp': 1, 'tp': 2}: 2 heads a rank" in out
    assert re.search(r"served 3 requests, 12 tokens in [\d.]+s", out)
    assert "served" not in worker[1]     # rank 0 prints
    assert math.isfinite(float(re.search(r"\(([\d.]+) tok/s\)",
                                         out).group(1)))
