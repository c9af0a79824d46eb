#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``pytorch_distributed_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and
prints one JSON line per phase:

  device   the card (``nvidia-smi`` name and power limit), library versions
           and the kernel build time;
  kernels  each CUDA kernel against its plain PyTorch version at the main
           path's shapes, in fp32 and bf16, with its time, the plain
           version's time, the least time the card could take (bound) and
           one PyTorch library call's time for comparison;
  parity   GPT-2 125M at full width, fp32, paged cache: the engine's greedy
           tokens equal the argmax of the port's own uncached forward, and
           every decode step of every layer launched the kernel;
  serve    the main path: GPT-2 125M at full width in bf16, 16 requests with
           a shared prefix through the continuous-batching scheduler over
           the paged cache;
  profile  torch.profiler over 10 decode steps of that engine: host wall
           time against device busy time per step, and the top kernels.

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pytorch_distributed_tpu_torch.models import gpt2_125m
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops import paged_attention as pa
from pytorch_distributed_tpu_torch.serving import (
    InferenceEngine,
    Request,
    Scheduler,
)

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

KERNEL_SOURCE = "pytorch_distributed_tpu_torch/ops/csrc/paged_decode_attention.cu"
KERNEL_REPLACES = "pytorch_distributed_tpu/ops/paged_attention.py:128"
TOLERANCE = {"float32": 2e-5, "bfloat16": 1.6e-2}  # atol = rtol


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int, flush) -> float:
    """Median device time of one call, CUDA events around each call, with
    the 50 MB L2 cache flushed before it (decode finds the pools cold)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_phase():
    """B7 at GPT-2 125M geometry (H=12, D=64, page 16, 8 sequences, 64 table
    entries): ragged lengths, an all-zero (trash) row, shuffled page ids."""
    B, H, D, page, M = 8, 12, 64, 16, 64
    S = M * page
    P = B * M + 1
    g = torch.Generator().manual_seed(0)
    lengths = torch.tensor([0, 1, 15, 16, 17, 300, 1023, 0], dtype=torch.int32)
    trash_row = 7  # inactive slot: all-zero table row, length 0
    perm = torch.randperm(P - 1, generator=g) + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
    for b in range(B):
        if b != trash_row:
            n = int(lengths[b]) // page + 1
            tables[b, :n] = perm[b * M: b * M + n].int()
    last = torch.clamp(lengths.long(), max=S - 1)
    n_visible = int((last + 1).sum())              # K/V rows the query reads
    n_entries = int((last // page + 1).sum())      # table entries it reads
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        q = torch.randn(B, 1, H, D, generator=g).to(dtype).cuda()
        kp = torch.randn(P, page, H, D, generator=g).to(dtype).cuda()
        vp = torch.randn(P, page, H, D, generator=g).to(dtype).cuda()
        tbl, lens = tables.cuda(), lengths.cuda()
        args = (q, kp, vp, tbl, lens)
        out = pa.paged_decode_attention(*args)
        ref = pa.paged_decode_attention_reference(*args)
        torch.cuda.synchronize()
        tol = TOLERANCE[name]
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
              f"kernel vs plain version in {name}: max_abs_err {err}")

        # library yardstick: SDPA over a dense view gathered beforehand (the
        # gather is excluded from its time), masked to positions <= length
        kd = kp[tbl.long()].reshape(B, S, H, D).transpose(1, 2).contiguous()
        vd = vp[tbl.long()].reshape(B, S, H, D).transpose(1, 2).contiguous()
        qd = q.transpose(1, 2).contiguous()
        mask = (torch.arange(S, device="cuda")[None, :] <= lens.long()[:, None])
        mask = mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
        lib_err = (lib_out.transpose(1, 2).float() - ref.float()).abs().max().item()

        elt = q.element_size()
        n_bytes = (2 * n_visible * H * D * elt + 2 * B * H * D * elt
                   + 4 * n_entries + 4 * B)
        n_flops = 4 * n_visible * H * D
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
        results[name] = {
            "max_abs_err": err,
            "tolerance": tol,
            "ms": time_ms(lambda: pa.paged_decode_attention(*args),
                          200, flush),
            "plain_ms": time_ms(
                lambda: pa.paged_decode_attention_reference(*args),
                20, flush),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask), 200, flush),
            "library_max_abs_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes,
            "flops": n_flops,
        }
    emit({"phase": "kernels", "kernel": "paged_decode_attention",
          "shape": {"B": B, "H": H, "D": D, "page_size": page,
                    "max_pages": M, "n_pages": P,
                    "lengths": lengths.tolist(), "trash_row": trash_row},
          "library_call": "F.scaled_dot_product_attention on a dense view "
                          "gathered beforehand (gather excluded)",
          "results": results})
    return results


def parity_phase():
    """fp32 full-width GPT-2 125M: engine greedy == uncached argmax."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt2_125m(device="cuda", seed=0)
    cfg = model.cfg
    engine = InferenceEngine(model, n_slots=8, max_len=1024, prefill_len=128,
                             cache_kind="paged", page_size=16)
    sched = Scheduler(engine, emit_events=False)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 37)]
    n_new = 12
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=n_new))
    pa.launches = 0
    finished = sched.run()
    launches = pa.launches
    got = {f.request_id: f.tokens for f in finished}
    want = {}
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            seq = [int(t) for t in p]
            for _ in range(n_new):
                logits = model(torch.tensor([seq], device="cuda"))
                seq.append(int(torch.argmax(logits[0, -1])))
            want[rid] = seq[len(p):]
    expected = cfg.n_layer * sched.decode_steps
    emit({"phase": "parity", "dtype": "float32", "requests": len(prompts),
          "new_tokens": n_new, "tokens_match": got == want,
          "launches": launches, "expected_launches": expected,
          "decode_steps": sched.decode_steps})
    check(got == want, f"greedy tokens {got} != uncached argmax {want}")
    check(launches == expected > 0,
          f"kernel launches {launches} != n_layer x decode steps {expected}")


def serve_phase():
    """The main path: bf16 GPT-2 125M serving 16 shared-prefix requests."""
    model = gpt2_125m(device="cuda", seed=1, dtype=torch.bfloat16)
    cfg = model.cfg
    kw = dict(n_slots=8, max_len=1024, prefill_len=128, cache_kind="paged",
              page_size=16)
    engine = InferenceEngine(model, **kw)
    rng = np.random.default_rng(2)
    # warm-up on a throwaway scheduler (its own cache and radix tree)
    warm = Scheduler(engine, emit_events=False)
    warm.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 40),
                        max_new_tokens=4))
    warm.run()
    del warm

    sched = Scheduler(engine, emit_events=False)
    shared = rng.integers(0, cfg.vocab_size, 32)
    n_req, n_new = 16, 64
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    int(rng.integers(8, 65)))])
               for _ in range(n_req)]
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=n_new))
    torch.cuda.synchronize()
    pa.launches = 0
    t0 = time.perf_counter()
    finished = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    stats = sched.stats()
    sched.allocator.check()
    emit({"phase": "serve", "model": "gpt2-125m", "dtype": "bfloat16",
          "n_slots": kw["n_slots"], "max_len": kw["max_len"],
          "page_size": kw["page_size"], "prefill_len": kw["prefill_len"],
          "requests": n_req, "shared_prefix": len(shared),
          "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
          "finished": len(finished), "wall_s": wall,
          "tokens_per_s": stats["tokens_generated"] / wall,
          "decode_step_p50_s": stats["decode_step_p50_s"],
          "decode_step_p99_s": stats["decode_step_p99_s"],
          "ttft_p50_s": stats["ttft_p50_s"],
          "radix_hits": stats["radix_hits"],
          "prefill_tokens_cached": stats["prefill_tokens_cached"],
          "decode_steps": sched.decode_steps, "kernel_launches": launches})
    check(len(finished) == n_req, f"{len(finished)} of {n_req} requests done")
    check(all(len(f.tokens) == n_new and f.reason == "length"
              and all(0 <= t < cfg.vocab_size for t in f.tokens)
              for f in finished), "a request's tokens are short or out of vocab")
    check(int(sched.allocator.reserved.sum()) == 0, "reservations not drained")
    check(stats["radix_hits"] >= n_req - 1, "shared prefix missed the radix")
    check(launches == cfg.n_layer * sched.decode_steps > 0,
          f"kernel launches {launches} != n_layer x decode steps")
    return launches, engine


def profile_phase(engine):
    """Where a decode step's time goes: torch.profiler over 10 steady decode
    steps of the serve engine at 8 active slots (host wall time vs device
    busy time, and the top kernels by device time)."""
    rng = np.random.default_rng(3)
    sched = Scheduler(engine, emit_events=False)
    for _ in range(engine.n_slots):
        sched.submit(Request(prompt=rng.integers(0, engine.cfg.vocab_size, 48),
                             max_new_tokens=16))
    sched.step()  # admissions and the first decode stay outside the window
    torch.cuda.synchronize()
    steps0 = sched.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_steps = sched.decode_steps - steps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    paged_ms = sum(e.self_device_time_total for e in kernels
                   if "paged_decode" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit({"phase": "profile", "decode_steps": n_steps,
          "wall_ms_per_step": wall_ms / n_steps,
          "device_busy_ms_per_step": busy_ms / n_steps,
          "device_busy_share": busy_ms / wall_ms,
          "paged_decode_ms_per_step": paged_ms / n_steps,
          "device_kernels_per_step": sum(e.count for e in kernels) / n_steps,
          "top_kernels": [{"name": e.key[:80],
                           "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                           "calls_per_step": e.count / n_steps} for e in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load("paged_decode_attention")
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    kres = kernel_phase()
    parity_phase()
    torch.cuda.empty_cache()
    launches, engine = serve_phase()
    profile_phase(engine)

    main_dtype = kres["bfloat16"]  # the serve phase runs in bf16
    emit({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": main_dtype["max_abs_err"],
        "ms": main_dtype["ms"],
        "plain_ms": main_dtype["plain_ms"],
        "bound_ms": main_dtype["bound_ms"],
        "bound_by": main_dtype["bound_by"],
        "library_ms": main_dtype["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
