"""The crop's forward plus d theta call at the training shapes (N = the
cell's batch), as a share of its least time (``cropbench``)."""

from perfbench.cropbench import roofline_percent


def read(ctx):
    return roofline_percent(ctx, ctx.traffic["batch"], backward=True)
