"""The share of the traced window in which no operation ran on the device,
in the ResNet cells: 1 - (the union of the device operations' intervals)
over (the first operation's start to the last one's end)."""

from portbench import trace

LAYER = "device"
UNIT = "%"
MOVES = "images_per_s"
ACROSS_RANKS = "mean"


def read(ctx):
    return trace.idle_percent(ctx["trace"])
