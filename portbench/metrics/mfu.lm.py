"""GPT-2's model FLOPs a step (``counts.lm_train_flops_per_token`` times
the rank's tokens) over the traced window's device time a step times the
card's published bf16 dense peak, in percent."""

from portbench import counts, trace

LAYER = "model step"
UNIT = "%"
MOVES = "tokens_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    cfg, cell, peaks = ctx["cfg"], ctx["cell"], ctx["peaks"]
    bw = trace.busy_window(ctx["trace"])
    if bw is None or peaks is None or not ctx["steps"]:
        return None
    flops = counts.lm_train_flops_per_token(
        cfg["n_layer"], cfg["n_embd"], cfg["vocab_size"], cell["seq_len"]
    ) * cell["batch"] * cell["seq_len"] * ctx["steps"]
    return 100.0 * flops / (bw[1] * peaks["bf16_flops"])
