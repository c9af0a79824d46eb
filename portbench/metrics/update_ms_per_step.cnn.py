"""Device ms a step of ResNet-50's update: the program's span ``update``
(the gradients' norm and SGD's step), averaged over the ranks."""

from portbench import spans

LAYER = "model step"
UNIT = "ms"
MOVES = "images_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    return spans.ms_per_step(ctx["trace"], ("update",), ctx["steps"])
