"""Run one cell of the benchmark once, and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run is one process (and, for a cell on several chips, one more process a
further chip, which this one starts and waits for; the ranks meet over a
TCP store on a free localhost port). It:

1. builds the port's trainer for the cell (``drivers/<driver>.py``) with
   weights and inputs made from ``--seed``, and its pipelined runner
   (``pipeline_exec.AsyncRunner``: one CUDA graph replay a step, the
   metric ring); the runner's start warms every shape up and captures;
2. runs the first steps through that runner and feed, keeping what the
   comparison needs (the losses, the optimizer's first gradient, the
   parameters' change);
3. measures for ``--seconds`` (set-up ends at the first timed step): the
   host submits steps until the time is up, a CUDA event after each
   submit gives the step intervals; with ``--trace 1`` a few more steps
   run under the profiler and the cell's per-layer metrics are read from
   that trace;
4. frees the program, runs the plain reference over the same first
   steps, decides ``correct`` with the cell's limits, checks that no JAX
   module was loaded, and prints the numbers compared (standard error)
   and the result line (standard output), both last.

Without a card (or with fewer cards than the cell asks for) it prints no
result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from datetime import timedelta  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import generate, guard, judge, manifest, trace  # noqa: E402
from portbench.reference import common  # noqa: E402

#: steps run in set-up and compared with the reference
CHECKED_STEPS = 3
#: on several chips, the ranks agree every this many steps whether the
#: window goes on (rank 0's clock decides)
AGREE_EVERY = 4


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What one rank of a run needs."""
    manifest: dict
    workload: dict
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    rank: int = 0
    world: int = 1
    store: Any = None
    #: the process's start on the host clock (set-up is measured from it)
    t0: float = T0
    #: a fault planted in the program's model (``faults.PLANTS``), or None
    plant: Any = None


class Stamps:
    """A mark after each submitted step: CUDA events on the card, the host
    clock elsewhere (CPU rehearsals only)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self._torch = torch
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(run: Run) -> None:
    import torch.distributed as dist

    if run.world > 1:
        dist.barrier()
    _sync(run.device)


def first_steps(run: Run, drv, trainer, runner, feed, batch) -> dict:
    """Steps 1..CHECKED_STEPS through the window's runner and feed, and the
    program's reading of them (losses filled in from the ring later)."""
    from portbench import program

    runner.submit(batch)
    runner.sync()
    grad = common.norms(drv.views(program.first_grad(trainer,
                                                     run.cfg["optimizer"])))
    for _ in range(CHECKED_STEPS - 1):
        runner.submit(next(feed))
    runner.sync()
    p0 = generate.make_params(drv.specs(run.cfg), run.seed, run.device)
    now = program.params_now(trainer.model)
    change = common.norms(drv.views({n: now[n] - p0[n] for n in now}))
    del p0
    return {"grad": grad, "change": change}


def _go_on(run: Run, n: int, deadline: float) -> bool:
    """Whether step ``n + 1`` is submitted: rank 0's clock, shared over the
    store every :data:`AGREE_EVERY` steps on several chips."""
    if run.world == 1:
        return time.perf_counter() < deadline
    if n % AGREE_EVERY:
        return True
    key = f"go{n}"
    if run.rank == 0:
        run.store.set(key, "1" if time.perf_counter() < deadline else "0")
    return run.store.get(key) == b"1"


def per_layer(run: Run, tr: trace.Trace, steps: int) -> Dict[str, float]:
    """This rank's reading of each per-layer metric of the cell (a reader
    that finds nothing returns None, and the metric is left out)."""
    from portbench import counts

    import torch

    name = (torch.cuda.get_device_name(run.device)
            if run.device.type == "cuda" else "cpu")
    ctx = {"cfg": run.cfg, "cell": run.cell, "trace": tr, "steps": steps,
           "families": manifest.kernel_families(), "peaks": counts.peaks(name),
           "world": run.world}
    out = {}
    for m in manifest.metrics_of(run.manifest, "per_layer", run.workload["name"]):
        value = manifest.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = value
    return out


@dataclasses.dataclass
class Built:
    """The program built for a run, after its checked steps."""
    trainer: Any
    runner: Any
    feed: Any
    state: Any
    reading: dict


def setup(run: Run) -> Built:
    """Build the cell's trainer and runner (the runner's start warms up and
    captures), and run the checked steps through them."""
    from portbench import program

    drv = manifest.driver(run.cell["driver"])
    trainer, feed = drv.build(run.cfg, run.cell, run.seed, run.device,
                              run.world, run.rank)
    if run.plant is not None:
        run.plant(trainer.model)
    state = trainer.init()
    runner = program.runner(trainer, run.cell)
    batch = next(feed)
    runner.start(state, batch)
    reading = first_steps(run, drv, trainer, runner, feed, batch)
    state, hist = runner.finish()
    reading["losses"] = [float(x) for x in hist["loss"][:CHECKED_STEPS]]
    return Built(trainer, runner, feed, state, reading)


def free(s: Built) -> None:
    """Drop the program's state (its graphs and their memory pool too)."""
    import torch

    close = getattr(s.feed, "close", None)
    if close is not None:
        close()
    s.trainer = s.runner = s.feed = s.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(run: Run, precision: str = "fp32", keep=None,
              exchange: bool = True) -> dict:
    """The plain reference's reading of the checked steps (on several
    ranks with BatchNorm's sums and the gradients over all of them, unless
    ``exchange`` is off)."""
    group = None
    if run.world > 1 and exchange:
        import torch.distributed as dist

        group = dist.group.WORLD
    drv = manifest.driver(run.cell["driver"])
    batches = drv.reference_batches(run.cfg, run.cell, run.seed, run.device,
                                    run.rank, CHECKED_STEPS)
    params0 = generate.make_params(drv.specs(run.cfg), run.seed, run.device)
    return drv.reference(run.cfg, run.cell, params0, batches, precision,
                         keep, group)


def measure(run: Run, s: Built) -> Dict[str, Any]:
    """The window (and with ``--trace 1`` the traced steps after it)."""
    import torch

    runner, feed = s.runner, s.feed
    batch = next(feed)
    runner.start(s.state, batch)        # the captured step: no new capture
    _barrier(run)
    setup_s = time.perf_counter() - run.t0
    stamps = Stamps(run.device)
    stamps.mark()
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    n = 0
    while True:
        runner.submit(batch)
        stamps.mark()
        n += 1
        if not _go_on(run, n, deadline):
            break
        batch = next(feed)
    s.state, hist = runner.finish()
    window_s = time.perf_counter() - t_start
    out = {
        "setup_s": setup_s, "window_s": window_s, "steps": n,
        "failed": int(sum(not math.isfinite(float(x)) for x in hist["loss"])),
        "intervals_ms": stamps.intervals_ms(),
        "peak_bytes": (torch.cuda.max_memory_allocated(run.device)
                       if run.device.type == "cuda" else 0),
    }
    if run.trace:
        steps = run.cell["traced_steps"]
        batches = [next(feed) for _ in range(steps)]
        runner.start(s.state, batches[0])
        _barrier(run)

        def traced():
            for b in batches:
                runner.submit(b)
            runner.sync()

        tr = trace.record(traced)
        s.state, _ = runner.finish()
        out["busy_window"] = trace.busy_window(tr)
        out["per_layer"] = per_layer(run, tr, steps)
        out["breakdown"] = trace.breakdown(tr)
    return out


def _say(run: Run, what: str) -> None:
    if run.rank == 0:
        print(f"[{time.perf_counter() - run.t0:8.2f} s] {what}", file=sys.stderr,
              flush=True)


def run_rank(run: Run) -> Dict[str, Any]:
    """One rank's run: set-up and checked steps, the window, then the
    reference. Returns this rank's part of the result."""
    _say(run, "start")
    s = setup(run)
    _say(run, "set-up and checked steps done")
    out = measure(run, s)
    _say(run, f"window done: {out['steps']} steps")
    free(s)
    out["numbers"] = judge.gaps(s.reading, reference(run))
    _say(run, "reference done")
    out["forbidden"] = guard.forbidden_modules()
    return out


def _combine(run: Run, parts: List[Dict[str, Any]]):
    """The result line and the checks from every rank's part."""
    import torch

    wl, first = run.workload, parts[0]
    drv = manifest.driver(run.cell["driver"])
    intervals = sorted(x for p in parts for x in p["intervals_ms"])
    p95 = intervals[max(0, math.ceil(0.95 * len(intervals)) - 1)]
    work = drv.work_per_step(run.cell) * run.world * first["steps"]
    values = {
        f"{drv.WORK}_per_s": (work / first["window_s"], f"{drv.WORK}/s"),
        "step_ms_p95": (p95, "ms"),
        "peak_mem_gib": (max(p["peak_bytes"] for p in parts) / 2 ** 30, "GiB"),
        "setup_s": (first["setup_s"], "s"),
    }
    metrics = {}
    if run.trace:
        for m in manifest.metrics_of(run.manifest, "per_layer", wl["name"]):
            got = [p["per_layer"][m["name"]] for p in parts
                   if m["name"] in p["per_layer"]]
            if len(got) == len(parts):
                reader = manifest.metric_reader(m["name"])
                value = (max(got) if getattr(reader, "ACROSS_RANKS", "mean")
                         == "max" else sum(got) / len(got))
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(run.manifest, "end_to_end", wl["name"]):
            value, _ = values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = run.device.type == "cuda"
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
        "count": run.world,
        "memory_peak_bytes": max(p["peak_bytes"] for p in parts),
        "power_limit_w": _power_limit() if on_card else None,
    }
    line = {"correct": None, "attempted": first["steps"],
            "failed": max(p["failed"] for p in parts), "metrics": metrics,
            "device": device}
    if run.trace:
        bw = [p["busy_window"] for p in parts]
        if all(b is not None for b in bw):
            device["busy_s"] = sum(b[0] for b in bw) / len(bw)
            device["window_s"] = sum(b[1] for b in bw) / len(bw)
        line["breakdown"] = first["breakdown"]
    numbers = judge.worst(p["numbers"] for p in parts)
    correct, checks = judge.verdict(numbers, run.cell["limits"])
    line["correct"] = bool(correct) and line["failed"] == 0
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line, checks


def _finite(x: float):
    return x if math.isfinite(x) else str(x)


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def report(run: Run, parts: List[Dict[str, Any]]) -> int:
    """Print the numbers compared and the result line, unless a forbidden
    module was loaded somewhere."""
    found = sorted({m for p in parts for m in p["forbidden"]})
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        return 1
    line, checks = _combine(run, parts)
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _watch(children: List[subprocess.Popen]) -> None:
    """End the run when a rank fails: the others would wait for it."""
    while True:
        for c in children:
            rc = c.poll()
            if rc not in (None, 0):
                print(f"a rank process exited {rc}", file=sys.stderr, flush=True)
                for other in children:
                    if other.poll() is None:
                        other.kill()
                for other in children:
                    other.wait()
                os._exit(1)
        if all(c.poll() == 0 for c in children):
            return
        time.sleep(0.5)


def _watch_parent(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def ranks(module: str, argv: List[str], rank: Optional[int],
          port: Optional[int], world: int):
    """``(rank, store, children)``: on one chip ``(0, None, [])``; else the
    first process makes the TCP store on a free localhost port and starts
    ``python -m module argv --rank r --port p`` for the other ranks (its
    watcher ends the run if one fails), and a started rank joins the store
    (and ends itself if the first process goes)."""
    import torch.distributed as dist

    if world == 1:
        return 0, None, []
    timeout = timedelta(seconds=300)
    if rank is None:
        port = _free_port()
        store = dist.TCPStore("localhost", port, world, True, timeout,
                              wait_for_workers=False)
        children = [subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(r),
             "--port", str(port)], stdout=sys.stderr, cwd=str(manifest.ROOT))
            for r in range(1, world)]
        threading.Thread(target=_watch, args=(children,), daemon=True).start()
        return 0, store, children
    threading.Thread(target=_watch_parent, args=(os.getppid(),),
                     daemon=True).start()
    return rank, dist.TCPStore("localhost", port, world, False, timeout), []


def gather(run: Run, part) -> list:
    """Every rank's ``part``, on every rank."""
    if run.world == 1:
        return [part]
    import torch.distributed as dist

    parts = [None] * run.world
    dist.all_gather_object(parts, part)
    return parts


def children_done(children: List[subprocess.Popen]) -> bool:
    for c in children:
        if c.wait(timeout=120) != 0:
            print(f"a rank process exited {c.returncode}", file=sys.stderr)
            return False
    return True


def load_cell(name: str):
    """``(manifest, workload, cell, config)`` of the cell ``name``."""
    mf = manifest.load()
    wl = manifest.workload(mf, name)
    return mf, wl, manifest.cell_file(name), manifest.config_file(mf, wl["config"])


def card(chips: int):
    """The card this process runs on after checking that there are
    ``chips`` of them; None (with the reason on standard error) if not."""
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"the cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return None
    return found


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(manifest.ROOT / ".portbench-cache" / sub))
    try:
        mf, wl, cell, cfg = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cannot load the cell {args.workload!r}: {e}", file=sys.stderr)
        return 2
    import torch

    chips = wl["chips"]
    if card(chips) is None:
        return 3
    rank, store, children = ranks("portbench.run", argv, args.rank, args.port,
                                  chips)
    run = Run(mf, wl, cell, cfg, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", rank), rank, chips, store)
    torch.cuda.set_device(run.device)
    from portbench import program

    try:
        if chips > 1:
            program.init_group(rank, chips, store, run.device)
        parts = gather(run, run_rank(run))
    finally:
        program.destroy_group()
    if rank:
        return 0
    if not children_done(children):
        return 1
    return report(run, parts)


if __name__ == "__main__":
    sys.exit(main())
