"""The crop's forward at the serving batch, as a share of its least time
(``cropbench``)."""

from perfbench.cropbench import roofline_percent


def read(ctx):
    return roofline_percent(ctx, ctx.traffic["batch"], backward=False)
