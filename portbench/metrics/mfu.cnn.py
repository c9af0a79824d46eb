"""ResNet's model FLOPs a step (``counts.resnet_forward_flops`` times 3,
times the rank's images) over the traced window's device time a step
times the card's published bf16 dense peak, in percent."""

from portbench import counts, trace

LAYER = "model step"
UNIT = "%"
MOVES = "images_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    cfg, cell, peaks = ctx["cfg"], ctx["cell"], ctx["peaks"]
    bw = trace.busy_window(ctx["trace"])
    if bw is None or peaks is None or not ctx["steps"]:
        return None
    flops = counts.train_flops(counts.resnet_forward_flops(
        cfg["layers"], cfg["width"], cfg["num_classes"], cfg["image_size"])
    ) * cell["batch"] * ctx["steps"]
    return 100.0 * flops / (bw[1] * peaks["bf16_flops"])
