"""Run a function on several gloo ranks of the PyTorch port, one spawned
process each, over a FileStore in a test's temporary directory.

``start(fn, store_dir, *args)`` spawns the ranks and returns at once, so
the test can compute its JAX reference meanwhile; ``finish(ctx)`` waits
for them with a deadline and re-raises a rank's exception. ``fn(rank,
store_dir, *args)`` must be a module-level function of a module that
imports without JAX: each rank imports it afresh.
"""

import time
from datetime import timedelta

import torch.multiprocessing as mp

WORLD = 4


def _entry(rank, fn, store_dir, world, args):
    import torch

    from pytorch_distributed_tpu_torch import distributed as pdist

    torch.set_num_threads(1)
    pdist.init_process_group(init_method=f"file://{store_dir}/store",
                             rank=rank, world_size=world, device="cpu",
                             timeout=timedelta(seconds=120))
    try:
        fn(rank, store_dir, *args)
    finally:
        pdist.destroy_process_group()


def start(fn, store_dir, *args, world: int = WORLD):
    return mp.start_processes(_entry, args=(fn, str(store_dir), world, args),
                              nprocs=world, join=False, start_method="spawn")


def finish(ctx, timeout: float = 150.0) -> None:
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"the ranks did not finish in {timeout} s")
