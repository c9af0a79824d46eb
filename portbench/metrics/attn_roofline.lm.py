"""Causal attention's share of its roofline in the GPT-2 cells: the least
time of every layer's forward and backward (``counts``: the function's
work, each of the two's larger of bytes over 3.35 TB/s and operations
over the bf16 peak, from the model's shapes) over the device time of the
operations that ``kernels/attention.json`` classifies as attention, in
percent."""

from portbench import counts, trace

LAYER = "kernels"
UNIT = "%"
MOVES = "tokens_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    cfg, cell, peaks = ctx["cfg"], ctx["cell"], ctx["peaks"]
    seconds = trace.family_seconds(ctx["trace"], ctx["families"], "attention")
    if peaks is None or seconds <= 0:
        return None
    heads = cfg["n_head"]
    work = counts.causal_attention_work(
        cell["batch"], cell["seq_len"], heads, cfg["n_embd"] // heads, 2)
    bound = cfg["n_layer"] * ctx["steps"] * counts.roofline_seconds(
        work, peaks["bf16_flops"], peaks["hbm_bytes"])
    return 100.0 * bound / seconds
