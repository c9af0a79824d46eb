"""Device ms a step of BatchNorm over the dp group, forward and backward:
the program's span ``bn_group`` (every BatchNorm layer's casts, sums and
their all-reduce, normalisation and statistics update), on the rank that
spends the most."""

from portbench import spans

LAYER = "strategy and exchange"
UNIT = "ms"
MOVES = "images_per_s"
ACROSS_RANKS = "max"


def read(ctx):
    return spans.ms_per_step(ctx["trace"], ("bn_group",), ctx["steps"])
