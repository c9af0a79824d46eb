"""Multihost serving demo: an admission router over N host workers.

The port's counterpart of ``examples/serve_multihost.py``, with the same
flags and output lines and ``--device``: each "host" runs its own
continuous-batching ``Scheduler`` and ``InferenceEngine`` behind a
``HostWorker``; the ``Router`` admits requests against each host's load,
routes least-loaded first and reassembles the chunked token streams
exactly once. Here every host is a thread of one process over a
``HashStore``; between machines each worker is a process of its own and
the store a ``TCPStore``, through the same code. Weights are random, drawn
from ``--seed`` (every host builds the same model). The model computes in
bf16 on the CUDA card and in fp32 on the CPU, as the JAX script does on
and off a TPU. Every engine is warmed up (on the card: its kernels built,
its decode step captured as a CUDA graph, one request drained) before any
host registers, so no first step outlasts the heartbeat TTL, and before
any worker thread starts, so no capture meets another thread's launches.

Two local workers::

    python -m pytorch_distributed_tpu_torch.examples.serve_multihost \\
        --device cpu

Failure handling: kill host0 mid-decode and watch its requests refeed to
the survivors from their last committed token::

    python -m pytorch_distributed_tpu_torch.examples.serve_multihost \\
        --hosts 3 --evict

``main(argv)`` returns 0.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # model shape (random weights: the demo is about the control plane)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--embd", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=96)
    # serving topology
    p.add_argument("--hosts", type=int, default=2,
                   help="local host workers to start")
    p.add_argument("--slots", type=int, default=2,
                   help="decode batch width per host")
    p.add_argument("--prefill-len", type=int, default=32)
    p.add_argument("--queue-depth", type=int, default=2,
                   help="per-host admission queue beyond the slots")
    p.add_argument("--heartbeat-ttl", type=float, default=5.0,
                   help="seconds without a heartbeat before eviction "
                        "(safe because every engine is warm before the "
                        "router starts watching)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=48)
    # failure demo
    p.add_argument("--evict", action="store_true",
                   help="kill host0 mid-decode; its requests refeed")
    p.add_argument("--kill-after", type=float, default=0.3,
                   help="seconds after the first route before the kill "
                        "(sooner once host0 has committed a strict prefix "
                        "of one of its streams: the kill lands mid-decode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from pytorch_distributed_tpu_torch import resolve_device
    from pytorch_distributed_tpu_torch.distributed.store import HashStore
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.observability import recent_events
    from pytorch_distributed_tpu_torch.serving import (
        HostWorker,
        InferenceEngine,
        Request,
        Router,
        Scheduler,
    )

    device = resolve_device(args.device)
    cfg = GPT2Config(
        vocab_size=args.vocab,
        n_positions=args.seq_len,
        n_embd=args.embd,
        n_layer=args.layers,
        n_head=args.heads,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
    )

    rng = np.random.default_rng(args.seed)
    store = HashStore()
    workers, threads = [], []
    for i in range(args.hosts):
        engine = InferenceEngine(
            GPT2(cfg, device=device, seed=args.seed), n_slots=args.slots,
            max_len=args.seq_len, prefill_len=args.prefill_len,
            seed=args.seed, device=device,
        )
        sched = Scheduler(engine)    # on the card: captures the decode step
        # warm up BEFORE joining the pool, so that the first real step
        # cannot stall past the heartbeat TTL
        sched.submit(Request(prompt=rng.integers(0, args.vocab, 4),
                             max_new_tokens=2))
        while sched.has_work:
            sched.step()
        workers.append(HostWorker(store, sched, host_id=f"host{i}"))
        print(f"host{i}: engine warm ({args.slots} slots)", flush=True)
    for w in workers:
        w.register()
        t = threading.Thread(target=w.serve_forever, daemon=True)
        t.start()
        threads.append(t)

    router = Router(store, heartbeat_ttl_s=args.heartbeat_ttl,
                    queue_depth=args.queue_depth)
    for _ in range(args.requests):
        prompt_len = int(rng.integers(4, args.prefill_len // 2))
        router.submit(Request(prompt=rng.integers(0, args.vocab, prompt_len),
                              max_new_tokens=args.max_new_tokens))

    t0 = time.perf_counter()
    served, killed, first_route_at = 0, False, None
    while router.has_work:
        for fin in router.step():
            served += 1
            tail = " ".join(map(str, fin.tokens[:10]))
            more = "..." if len(fin.tokens) > 10 else ""
            print(f"req {fin.request_id}: prompt {len(fin.prompt)} tok "
                  f"-> +{len(fin.tokens)} [{fin.reason}] "
                  f"total {fin.total_s * 1e3:.1f}ms | {tail}{more}",
                  flush=True)
        if first_route_at is None and router.routed:
            first_route_at = time.monotonic()
        if args.evict and not killed and first_route_at is not None:
            mid_decode = any(
                inf.chan == workers[0].chan
                and 0 < len(inf.committed) < inf.max_new_tokens
                for inf in router._inflight.values())
            if (mid_decode or
                    time.monotonic() - first_route_at > args.kill_after):
                workers[0].kill()
                killed = True
                print(f"\n>>> killed host0 mid-decode; router evicts it "
                      f"after {args.heartbeat_ttl}s of heartbeat silence "
                      f"and refeeds its in-flight requests <<<\n",
                      flush=True)
        time.sleep(0.002)
    wall = time.perf_counter() - t0
    router.stop_hosts()
    for t in threads:
        t.join(timeout=30)

    s = router.stats()
    per_host = ", ".join(
        f"{h}: {n}" for h, n in sorted(s["per_host_routed"].items())
    )
    print(f"\nserved {served}/{args.requests} requests in {wall:.2f}s | "
          f"request p50 {s['request_p50_s'] * 1e3:.1f}ms "
          f"p99 {s['request_p99_s'] * 1e3:.1f}ms | "
          f"ttft p50 {s['ttft_p50_s'] * 1e3:.1f}ms")
    print(f"hosts {s['hosts_alive']}/{s['hosts']} alive | routes "
          f"{s['routed']} ({per_host}) | "
          f"rebalances {s['rebalances']} | evictions {s['evictions']} | "
          f"stale chunks fenced {s['stale_chunks']}")
    names = ("serving.route", "serving.rebalance", "serving.host_evict")
    counts = {n: 0 for n in names}
    for ev in recent_events(10_000):
        if ev.name in counts:
            counts[ev.name] += 1
    print("events: " + ", ".join(f"{n} x{c}" for n, c in counts.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
