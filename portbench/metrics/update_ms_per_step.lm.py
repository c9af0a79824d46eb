"""Device ms a step of GPT-2's update: the program's span ``update``
(unscale, the gradients' norm, clipping and AdamW's step)."""

from portbench import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "tokens_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    return spans.ms_per_step(ctx["trace"], ("update",), ctx["steps"])
