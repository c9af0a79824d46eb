"""Device ms a step of the gradient exchange over the dp group: the
program's span ``grad_exchange`` (the strategy's reduction: the gradients
concatenated, all-reduced, divided and split), on the rank that spends the
most."""

from portbench import spans

LAYER = "strategy and exchange"
UNIT = "ms"
MOVES = "images_per_s"
ACROSS_RANKS = "max"


def read(ctx):
    return spans.ms_per_step(ctx["trace"], ("grad_exchange",), ctx["steps"])
