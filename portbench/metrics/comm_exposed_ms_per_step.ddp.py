"""Milliseconds a step in which an NCCL operation runs on the device and
no other operation does, on the rank that has the most."""

from portbench import trace

LAYER = "strategy and exchange"
UNIT = "ms"
MOVES = "images_per_s"
ACROSS_RANKS = "max"


def read(ctx):
    if trace.family_seconds(ctx["trace"], ctx["families"], "nccl") <= 0:
        return None
    return 1e3 * trace.exposed_seconds(ctx["trace"], ctx["families"],
                                       "nccl") / ctx["steps"]
