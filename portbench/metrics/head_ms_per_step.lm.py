"""Device ms a step of GPT-2's tied LM head and its loss, forward and
backward: the program's spans ``lm_head`` (the head's products) and
``lm_loss`` (the fp32 logits' cast and the cross-entropy)."""

from portbench import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "tokens_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    return spans.ms_per_step(ctx["trace"], ("lm_head", "lm_loss"),
                             ctx["steps"])
