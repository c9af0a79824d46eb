"""The port's twin of the root ``bench.py``: ResNet-50 training throughput on
one CUDA card, printed as ONE JSON line with ``bench.py``'s keys.

The step is ``bench.py``'s: ResNet-50, batch 128 at 224 px, the ``bf16``
policy (the model computes in bf16, parameters in fp32), ``SGD(0.1,
momentum=0.9)``, softmax cross-entropy, on one device-resident fixed batch
made from seed 0, through the port's ``Trainer`` under ``NoShard`` (the
data-parallel strategy of a one-device mesh)::

    python -m pytorch_distributed_tpu_torch.bench            # the card
    python -m pytorch_distributed_tpu_torch.bench --device cpu   # smoke

Honesty rules, kept from ``bench.py``:

* throughput comes from the pipelined executor, the product path
  (``pipeline_exec.AsyncRunner``: one CUDA graph replay a step, two steps
  in flight, the metric ring drained once): 3 warm-up submits closed by
  ``sync()``, then 50 timed submits closed by ``finish()``, the one
  chain-closing host read;
* 15 more steps of the eager ``Trainer.step``, each synchronized, give the
  step time's p50, p90 and p99 (the stall the runner removes);
* the loss must fall from the last warm-up step, or end below 0.9 ln 1000
  (the fixed batch is memorised); otherwise no throughput is reported;
* MFU counts 4.09 x 3 GFLOP per 224 px image (forward + backward) against
  the card's published bf16 peak (keyed by device name); an MFU above 1
  switches to the synchronized p50, and raises if that is above 1 too;
* the metric's name says the shapes that ran: off the card (``--device
  cpu``) a small shape runs, the model computes in fp32, and the metric is
  ``resnet50_smoke_bs{B}_{H}px_images_per_sec``.

cuDNN's algorithm search (``torch.backends.cudnn.benchmark``) is switched
on before the warm-up, and its state is in the line.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

# ResNet-50 at 224x224: 4.09 GFLOP forward per image (conv + fc MACs x 2);
# a training step is about 3x the forward
RESNET50_TRAIN_GFLOP_PER_IMG_224 = 4.09 * 3

# Published dense bf16 tensor-core peaks (NVIDIA data sheets), keyed by a
# substring of torch.cuda.get_device_name; the first match wins, and "H100"
# alone is the SXM part
PEAK_BF16_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
)

IMAGENET = dict(batch=128, hw=224, steps=50, sync_steps=15, warmup=3)
SMOKE = dict(batch=8, hw=64, steps=6, sync_steps=3, warmup=1)


def peak_bf16_flops(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAK_BF16_FLOPS if k in name), None)


def build(device, *, batch: int, hw: int, policy: str = "bf16",
          grad_accum_steps: int = 1):
    """The bench's trainer (ResNet-50, ``SGD(0.1, momentum=0.9)``, the
    model in the policy's compute dtype on the card and in fp32 on the
    CPU) and its fixed batch from seed 0 on ``device``."""
    from pytorch_distributed_tpu_torch.amp import get_policy
    from pytorch_distributed_tpu_torch.models import resnet50
    from pytorch_distributed_tpu_torch.parallel import NoShard
    from pytorch_distributed_tpu_torch.trainer import (
        Trainer,
        classification_loss,
    )

    dtype = (get_policy(policy).compute_dtype if device.type == "cuda"
             else torch.float32)
    model = resnet50(num_classes=1000, dtype=dtype, device=device, seed=0)
    strategy = NoShard(device)
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1,
                                             momentum=0.9),
                      strategy, loss_fn=classification_loss, policy=policy,
                      grad_accum_steps=grad_accum_steps)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 1000, batch).astype(np.int32)
    return trainer, strategy.place_batch((x, y))   # device-resident once


def run(device, *, batch: int, hw: int, steps: int, sync_steps: int,
        warmup: int) -> Dict:
    """Build the step, time it, and return the JSON line's fields."""
    from pytorch_distributed_tpu_torch import resolve_device
    from pytorch_distributed_tpu_torch.pipeline_exec import AsyncRunner

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cudnn.benchmark = True
    trainer, fixed = build(device, batch=batch, hw=hw)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # dispatch cost of one tiny dependent op, for the step budget
    v = torch.zeros(8, device=device)
    sync()
    t0 = time.perf_counter()
    for _ in range(50):
        v = v + 1.0
    float(v[0])
    dispatch_ms = (time.perf_counter() - t0) / 50 * 1e3

    state = trainer.init()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    # the product path: the runner (its start warms up, captures and puts
    # the warm-up's changes back, all off the clock)
    runner = AsyncRunner(trainer, depth=2, drain_every=warmup + steps)
    runner.start(state, fixed)
    for _ in range(warmup):
        runner.submit(fixed)
    runner.sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        runner.submit(fixed)
    dispatches = runner.dispatch_count
    state, hist = runner.finish()   # the one chain-closing host read
    dt_pipelined = time.perf_counter() - t0
    first_loss = float(hist["loss"][warmup - 1])  # the last warm-up step's

    # the deliberately synchronized eager steps
    step_times = []
    for _ in range(sync_steps):
        t1 = time.perf_counter()
        state, m = trainer.step(state, fixed)
        # graftlint: disable-next-line=host-sync-in-hot-loop -- the synchronous step-latency series: each timed step ends on its own loss read, by design
        float(m["loss"])            # per-step host sync
        step_times.append(time.perf_counter() - t1)
    final_loss = float(m["loss"])
    p50 = statistics.median(step_times)
    n = len(step_times)
    p90 = sorted(step_times)[max(0, -(-9 * n // 10) - 1)]  # nearest rank
    p99 = sorted(step_times)[max(0, -(-99 * n // 100) - 1)]

    chance = math.log(1000.0)
    trained = final_loss < first_loss or final_loss < 0.9 * chance
    if not trained or not math.isfinite(final_loss):
        raise RuntimeError(
            f"loss did not decrease ({first_loss:.4f} -> {final_loss:.4f}): "
            f"the step is not training; refusing to report throughput")

    images_per_sec = batch * steps / dt_pipelined
    images_per_sec_sync = batch / p50
    gflop_per_img = RESNET50_TRAIN_GFLOP_PER_IMG_224 * (hw / 224.0) ** 2
    peak = peak_bf16_flops(device)
    achieved_tflops = images_per_sec * gflop_per_img / 1000.0
    mfu = achieved_tflops * 1e12 / peak if peak else None
    anomaly = None
    if mfu is not None and mfu > 1.0:
        anomaly = (f"pipelined number implied MFU {mfu:.2f} > 1.0; "
                   f"reported the synchronized per-step median instead")
        images_per_sec = images_per_sec_sync
        achieved_tflops = images_per_sec * gflop_per_img / 1000.0
        mfu = achieved_tflops * 1e12 / peak
        if mfu > 1.0:
            raise RuntimeError(
                f"synchronized measurement still implies MFU {mfu:.2f} > 1.0 "
                f"against peak {peak / 1e12} TFLOP/s: the peak table is "
                f"wrong for this card")

    imagenet_shapes = hw == 224 and batch == 128
    metric = ("resnet50_imagenet_images_per_sec_per_chip" if imagenet_shapes
              else f"resnet50_smoke_bs{batch}_{hw}px_images_per_sec")
    step_ms_pipelined = dt_pipelined / steps * 1e3
    out = {
        "metric": metric,
        "value": images_per_sec,
        "unit": "images/sec",
        # the JAX bench's anchor is a TPU number: no ratio against it
        "vs_baseline": 0.0,
        "platform": "gpu" if on_card else "cpu",
        "device_kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
        "timed_steps": steps,
        "step_ms_p50": p50 * 1e3,
        "step_ms_p90": p90 * 1e3,
        "step_ms_p99": p99 * 1e3,
        "images_per_sec_blocking": images_per_sec_sync,
        "achieved_tflops": achieved_tflops,
        "mfu": mfu,
        "mfu_xla": None,            # no compiler cost analysis here
        "dispatch_ms_per_program": dispatch_ms,
        "step_budget": {"blocking_ms_p50": p50 * 1e3,
                        "dispatch_ms_per_program": dispatch_ms} if anomaly
        else {"pipelined_ms": step_ms_pipelined,
              "blocking_extra_ms": p50 * 1e3 - step_ms_pipelined,
              "dispatch_ms_per_program": dispatch_ms,
              "programs_per_step": runner.programs_per_step,
              "strategy": type(trainer.strategy).__name__,
              "sharded_update": runner.sharded_update,
              "runner_depth": runner.depth,
              "metric_drain_every": runner.drain_every},
        "loss_first": first_loss,
        "loss_last": final_loss,
        "runner": {"programs_per_step": runner.programs_per_step,
                   "dispatches": dispatches,
                   "graph": on_card},
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
        "secondary_unavailable": "the benchmark matrix is not ported",
    }
    if anomaly:
        out["anomaly"] = anomaly
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); off the "
                        "card the smoke shape runs")
    args = p.parse_args(argv)
    from pytorch_distributed_tpu_torch import resolve_device

    device = resolve_device(args.device)
    out = run(device, **(IMAGENET if device.type == "cuda" else SMOKE))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # always emit the one line
        print(json.dumps({
            "metric": "bench_error",
            "value": 0,
            "unit": "error",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {e}",
        }))
        sys.exit(1)
