"""One multihost ``HostWorker`` process of the PyTorch port on a TCPStore.

The port's twin of ``tests/mh_worker.py``, started as several real
processes against the parent's store master by
``tests/test_torch_port_multihost.py``: it loads the tiny GPT-2's weights
that the parent saved (the JAX model's, through the port's converter),
wraps them in a ``Scheduler`` and a ``HostWorker`` on the CPU, warms the
engine up, and serves until the router's stop key, or until the parent
SIGKILLs it mid-decode. The delay before each scheduler step keeps
decodes slow enough for a kill to land mid-stream. Imports no JAX.

    MH_PORT=<port> python tests/_torch_port_mh_worker.py <host_id> \\
        <step_delay_s> <state_dict.pt>
"""

import os
import sys
import time


def main() -> None:
    host_id, delay, weights = sys.argv[1], float(sys.argv[2]), sys.argv[3]

    import numpy as np
    import torch

    from pytorch_distributed_tpu_torch.distributed.store import TCPStore
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.serving import (
        InferenceEngine,
        Request,
        Scheduler,
    )
    from pytorch_distributed_tpu_torch.serving.multihost import HostWorker

    torch.set_num_threads(1)
    model = GPT2(GPT2Config(vocab_size=97, n_positions=48, n_embd=48,
                            n_layer=2, n_head=4), device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    engine = InferenceEngine(model, n_slots=2, max_len=48, prefill_len=32,
                             device="cpu")
    sched = Scheduler(engine, emit_events=False)
    sched.submit(Request(prompt=np.arange(4), max_new_tokens=2))
    sched.run()                          # warm before joining the pool
    if delay:
        real_step = sched.step

        def slow_step():
            time.sleep(delay)
            return real_step()

        sched.step = slow_step
    store = TCPStore("127.0.0.1", int(os.environ["MH_PORT"]))
    HostWorker(store, sched, host_id=host_id).serve_forever()
    print(f"{host_id}: drained, exiting", flush=True)


if __name__ == "__main__":
    main()
