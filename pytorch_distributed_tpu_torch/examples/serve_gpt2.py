"""GPT-2 serving demo: KV-cached continuous batching on one card.

The port's counterpart of ``examples/serve_gpt2.py``, with the same flags
and output lines: stream greedy or sampled generations for a batch of
synthetic prompts through the continuous-batching scheduler (requests join
and leave the decode batch per step, finished slots are reused at once).
Weights are random, drawn from ``--seed``. The model computes in bf16 on
the CUDA card (fp32 parameters) and in fp32 on the CPU, as the JAX script
does on and off a TPU. ``--device cpu`` runs the plain versions of the
kernels::

    python -m pytorch_distributed_tpu_torch.examples.serve_gpt2 \\
        --device cpu --layers 2 --embd 64 --heads 4 --vocab 256

Speculative decoding (self-drafting with the first ``--draft-layers``
target layers proposing ``--spec-k`` tokens per verify forward; the
default draft is the cheaper half of the stack)::

    python -m pytorch_distributed_tpu_torch.examples.serve_gpt2 \\
        --layers 4 --spec-k 3 --draft-layers 1

Greedy speculative output is token for token plain greedy decoding; the
run prints the accept rate and tokens per target forward at the end.

Paged KV cache with radix prefix sharing (``--shared-prefix N`` prepends
one common N-token prefix to every prompt, so admissions after the first
are served from cached pages)::

    python -m pytorch_distributed_tpu_torch.examples.serve_gpt2 \\
        --cache paged --page-size 16 --shared-prefix 16 --requests 8

A training checkpoint's weights (``--ckpt-dir``, the newest step or
``--step``; ``examples/train_gpt2.py --ckpt-dir`` writes them) load
through ``serving.load_gpt2_params``: only the model's entries are read.
``--tp``/``--dp`` serve over a ``(dp, tp)`` mesh of ``dp x tp`` ranks,
one process each, launched by ``torchrun`` or the port's launcher (NCCL
on the cards, gloo with ``--device cpu``): every tp rank holds its blocks
of the weights and its heads of the cache, the dp replicas serve the same
requests, and rank 0 prints::

    python -m pytorch_distributed_tpu_torch.elastic.run --standalone \\
        --nproc-per-node 2 \\
        -m pytorch_distributed_tpu_torch.examples.serve_gpt2 \\
        --tp 2 --device cpu --ckpt-dir ckpt

``main(argv)`` returns 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # model shape
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embd", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=128)
    # serving
    p.add_argument("--ckpt-dir", default=None,
                   help="training checkpoint dir (CheckpointManager's): "
                        "serve its weights")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size of the serving mesh")
    p.add_argument("--dp", type=int, default=1,
                   help="replicas of the serving mesh (same requests)")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent sequences (decode batch width)")
    p.add_argument("--max-len", type=int, default=None,
                   help="per-slot capacity (default: --seq-len)")
    p.add_argument("--prefill-len", type=int, default=32,
                   help="prompt pad bucket")
    p.add_argument("--requests", type=int, default=8,
                   help="synthetic prompts to serve")
    p.add_argument("--max-new-tokens", type=int, default=24)
    # paged KV cache + radix prefix sharing
    p.add_argument("--cache", choices=["slotted", "paged"],
                   default="slotted",
                   help="KV cache layout: per-slot reservation (slotted) "
                        "or page-granular with radix prefix sharing")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page (--cache paged)")
    p.add_argument("--n-pages", type=int, default=None,
                   help="page pool size (default: slots x max pages + 1)")
    p.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                   help="prepend one common N-token prefix to every "
                        "prompt (demonstrates radix cache hits; "
                        "--cache paged)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    # speculative decoding (self-drafting)
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens per verify forward (0 = off)")
    p.add_argument("--draft-layers", type=int, default=None,
                   help="target layers used as the self-draft model "
                        "(requires --spec-k >= 1; default layers // 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from pytorch_distributed_tpu_torch import distributed as pdist
    from pytorch_distributed_tpu_torch import resolve_device

    device = resolve_device(args.device)
    ranks = args.dp * args.tp
    own_group = ranks > 1 and not dist.is_initialized()
    if own_group:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--dp x --tp = {ranks} ranks: launch them "
                             "with torchrun or python -m "
                             "pytorch_distributed_tpu_torch.elastic.run")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        pdist.init_process_group(init_method="env://",
                                 rank=int(os.environ["RANK"]),
                                 world_size=int(os.environ["WORLD_SIZE"]),
                                 device=device)
    try:
        if ranks > 1 and dist.get_world_size() != ranks:
            raise SystemExit(f"--dp x --tp = {ranks} ranks, the process "
                             f"group has {dist.get_world_size()}")
        return _serve(args, device)
    finally:
        if own_group:
            pdist.destroy_process_group()


def _serve(args, device) -> int:
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        SamplingParams,
        Scheduler,
        kv_cache_sharding,
        load_gpt2_params,
        paged_kv_cache_sharding,
        serving_mesh,
        shard_gpt2_params,
    )

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = GPT2Config(
        vocab_size=args.vocab,
        n_positions=args.seq_len,
        n_embd=args.embd,
        n_layer=args.layers,
        n_head=args.heads,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )
    model = GPT2(cfg, device=device, seed=args.seed)
    mesh = cache_sharding = None
    if args.dp * args.tp > 1:
        mesh = serving_mesh(dp=args.dp, tp=args.tp)
        shard_gpt2_params(model, mesh)
        cache_sharding = (paged_kv_cache_sharding(mesh)
                          if args.cache == "paged"
                          else kv_cache_sharding(mesh))
    if args.ckpt_dir:
        step = load_gpt2_params(args.ckpt_dir, model, mesh, step=args.step)
        say(f"loaded params from {args.ckpt_dir} (step {step}"
            + (f", tp={args.tp}" if mesh else "") + ")", flush=True)
    else:
        say("serving RANDOM weights (no --ckpt-dir)", flush=True)

    if args.spec_k > 0 and args.draft_layers is None:
        # default self-draft: the cheaper half of the stack
        args.draft_layers = max(1, args.layers // 2)
    if args.shared_prefix and args.cache != "paged":
        raise SystemExit("--shared-prefix requires --cache paged "
                         "(the slotted cache has no prefix sharing)")
    if args.shared_prefix >= args.prefill_len:
        raise SystemExit(f"--shared-prefix {args.shared_prefix} must be "
                         f"< --prefill-len {args.prefill_len} (prompts "
                         "must fit the prefill bucket)")
    paged_kw = {}
    if args.cache == "paged":
        paged_kw = dict(cache_kind="paged", page_size=args.page_size,
                        n_pages=args.n_pages)
    engine = InferenceEngine(
        model,
        n_slots=args.slots,
        max_len=args.max_len or args.seq_len,
        prefill_len=args.prefill_len,
        sampling=SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p,
        ),
        seed=args.seed,
        spec_k=args.spec_k,
        draft_layers=args.draft_layers if args.spec_k > 0 else None,
        device=device,
        cache_sharding=cache_sharding,
        **paged_kw,
    )
    if mesh is not None:
        say(f"serving mesh {mesh.shape}: {args.heads // args.tp} heads a "
            f"rank, steps as {'graphs' if engine.graphs else 'eager bodies'}",
            flush=True)
    if args.cache == "paged":
        say(f"paged KV cache: page_size={engine.page_size}, "
            f"{engine.n_pages} pages "
            f"({engine.n_pages - 1} allocatable + trash)", flush=True)
    if args.spec_k > 0:
        say(f"speculative decoding: k={args.spec_k}, self-draft "
            f"{args.draft_layers}/{args.layers} layers", flush=True)
    sched = Scheduler(engine)

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, args.vocab, args.shared_prefix)
    for i in range(args.requests):
        lo = args.shared_prefix + 1
        prompt_len = int(rng.integers(max(4, lo),
                                      max(args.prefill_len, lo + 1)))
        prompt = rng.integers(0, args.vocab, prompt_len)
        if args.shared_prefix:
            prompt[: args.shared_prefix] = shared
        sched.submit(Request(prompt=prompt,
                             max_new_tokens=args.max_new_tokens))

    # streamed serving loop: print each request the step it completes
    t0 = time.perf_counter()
    served = 0
    while sched.has_work:
        for fin in sched.step():
            served += 1
            tail = " ".join(map(str, fin.tokens[:12]))
            more = "..." if len(fin.tokens) > 12 else ""
            say(f"req {fin.request_id}: prompt {len(fin.prompt)} tok "
                f"-> +{len(fin.tokens)} [{fin.reason}] "
                f"ttft {fin.ttft_s * 1e3:.1f}ms "
                f"total {fin.total_s * 1e3:.1f}ms | {tail}{more}",
                flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    s = sched.stats()
    say(f"\nserved {served} requests, "
        f"{int(s['tokens_generated'])} tokens in {wall:.2f}s "
        f"({s['tokens_generated'] / wall:.1f} tok/s)")
    say(f"decode step p50 {s['decode_step_p50_s'] * 1e3:.2f}ms "
        f"p99 {s['decode_step_p99_s'] * 1e3:.2f}ms | "
        f"ttft p50 {s['ttft_p50_s'] * 1e3:.1f}ms")
    if args.cache == "paged":
        total = int(s["prefill_tokens_total"])
        cached = int(s["prefill_tokens_cached"])
        frac = cached / total if total else 0.0
        say(f"paged cache: radix hits {int(s['radix_hits'])} / "
            f"misses {int(s['radix_misses'])}, "
            f"{cached}/{total} prefill tokens served from cache "
            f"({frac:.0%}), {int(s['free_pages'])} pages free")
    if args.spec_k > 0:
        say(f"spec k={int(s['spec_k'])}: accept-rate "
            f"{s['accept_rate']:.1%}, "
            f"{s['tokens_per_target_forward']:.2f} tokens per target "
            f"forward (batch-wide)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
