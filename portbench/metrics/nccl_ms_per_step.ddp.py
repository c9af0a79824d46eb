"""Device milliseconds a step of the operations that ``kernels/nccl.json``
classifies as NCCL's (the gradient all-reduce and BatchNorm's sums), on
the rank that spends the most."""

from portbench import trace

LAYER = "strategy and exchange"
UNIT = "ms"
MOVES = "images_per_s"
ACROSS_RANKS = "max"


def read(ctx):
    seconds = trace.family_seconds(ctx["trace"], ctx["families"], "nccl")
    if seconds <= 0 or not ctx["steps"]:
        return None
    return 1e3 * seconds / ctx["steps"]
