"""Checkpoints of a tensor-parallel GPT-2 trainer's state in the port
(``checkpoint/state_dict.py`` over ``parallel/tensor_parallel.py``).

On 4 gloo ranks (``tests/_torch_port_ranks.py``; rank body
``tests/_torch_port_tp.py::ckpt_resume_body``), the tiny GPT-2 of
``tests/test_tensor_parallel.py`` with AdamW at (dp 1, tp 4) with and
without sequence parallelism, at (dp 2, tp 2) and at (fsdp 2, tp 2) takes
2 steps, saves through ``CheckpointManager``, is restored into a fresh
trainer built from other random weights, and takes 2 more. The resumed
run must equal the uninterrupted one bit for bit (losses, whole
parameters, AdamW state), and both must be within 1e-5 of the JAX
``TensorParallel`` trainer's losses from the same weights. The saved
tensors have the unsharded model's keys and shapes (the fused ``c_attn``
is gathered whole over tp), so the checkpoint loads through
``serving.load_gpt2_params`` at tp 1 (here, one process) and at tp 2 (on
the ranks' (dp 2, tp 2) serving mesh): the weights are the live ones at
the save, and the greedy streams equal the JAX engine's on them.
"""

import numpy as np
import pytest
import torch

from tests import _torch_port_ranks as ranks
from tests import _torch_port_tp as tph

torch.set_num_threads(2)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def jax_losses(first):
    """The JAX TP trainer's losses on ``tph.lm_batch()`` from ``first``."""
    from tests.test_torch_port_tensor_parallel import jax_tp_trainer

    trainer, state, init = jax_tp_trainer()
    for name, t in first.items():
        torch.testing.assert_close(init[name], t, rtol=0, atol=0)
    losses = []
    for _ in range(tph.STEPS):
        state, m = trainer.step(state, tph.lm_batch())
        losses.append(float(m["loss"]))
    return losses


def jax_streams(state_dict):
    """The JAX engine's greedy streams of ``tph.ckpt_requests()`` on the
    port's ``state_dict``."""
    import jax.numpy as jnp

    from pytorch_distributed_tpu.models.gpt2 import GPT2 as JaxGPT2
    from pytorch_distributed_tpu.models.gpt2 import GPT2Config as JaxCfg
    from pytorch_distributed_tpu.serving import InferenceEngine as JaxEngine
    from pytorch_distributed_tpu.serving import Request as JaxRequest
    from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
    from pytorch_distributed_tpu_torch.models import gpt2_flax_from_state_dict

    model = JaxGPT2(JaxCfg(dtype=jnp.float32, **tph.TINY))
    variables = {"params": gpt2_flax_from_state_dict(state_dict)}
    sched = JaxScheduler(JaxEngine(model, variables, n_slots=2,
                                   max_len=tph.TINY["n_positions"],
                                   prefill_len=16), emit_events=False)
    for prompt, n_new in tph.ckpt_requests():
        sched.submit(JaxRequest(prompt=prompt, max_new_tokens=n_new))
    return {f.request_id: list(f.tokens) for f in sched.run()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_port_tensor_parallel import jax_tp_trainer

    tmp = tmp_path_factory.mktemp("ckpt_tp")
    _, _, first = jax_tp_trainer()
    ctx = ranks.start(tph.ckpt_resume_body, tmp, tph.CKPT_JOBS, first)
    want = jax_losses(first)
    ranks.finish(ctx, timeout=240)
    got = [torch.load(tmp / f"ckpt.rank{r}.pt", weights_only=False)
           for r in range(ranks.WORLD)]
    return tmp, got, want


@pytest.mark.parametrize("tag", [tag for tag, _, _ in tph.CKPT_JOBS])
def test_resume_is_bit_for_bit_and_matches_jax(runs, tag):
    _, got, want = runs
    for r in got:
        out = r[tag]
        assert out["restored_step"] == tph.CKPT_AT
        assert out["resumed"] == out["straight"]
        assert out["same_params"] and out["same_opt"]
    mean = np.mean([r[tag]["straight"] for r in got], axis=0)
    np.testing.assert_allclose(mean, want, rtol=1e-5)


@pytest.mark.parametrize("tag", [tag for tag, _, _ in tph.CKPT_JOBS])
def test_saved_shapes_are_the_unsharded_models(runs, tag):
    import torch.distributed.checkpoint as dcp

    tmp, got, _ = runs
    meta = dcp.FileSystemReader(str(tmp / f"ckpt_{tag}" /
                                    str(tph.CKPT_AT))).read_metadata()
    shapes = {k: tuple(v.size) for k, v in meta.state_dict_metadata.items()
              if hasattr(v, "size")}
    C, V = tph.TINY["n_embd"], tph.TINY["vocab_size"]
    assert shapes["model/h.0.attn.c_attn.weight"] == (3 * C, C)
    assert shapes["model/h.0.attn.c_attn.bias"] == (3 * C,)
    assert shapes["optim/h.0.attn.c_attn.weight/exp_avg_sq"] == (3 * C, C)
    assert shapes["model/h.1.mlp.c_proj.weight"] == (C, 4 * C)
    assert shapes["optim/wte/exp_avg"] == (V, C)
    assert shapes["model/wte"] == (V, C)


def test_load_gpt2_params_at_tp1_and_tp2(runs):
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import load_gpt2_params

    tmp, got, _ = runs
    tag = "dp2tp2_sp0"
    at_save = got[0][tag]["at_save"]
    model = GPT2(GPT2Config(**tph.TINY), device="cpu", seed=9)
    assert load_gpt2_params(str(tmp / f"ckpt_{tag}"), model) == tph.CKPT_AT
    for name, t in model.state_dict().items():
        assert torch.equal(t, at_save[name]), name
    want = jax_streams(at_save)
    assert tph.ckpt_streams(model) == want
    C = tph.TINY["n_embd"]
    for r in got:
        assert r[tag]["load_step"] == tph.CKPT_AT
        assert r[tag]["tp2_held"] == (3 * C // 2, C)
        assert r[tag]["tp2_streams"] == want
