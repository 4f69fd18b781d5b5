"""Synchronising runtime calls (``cuda*Synchronize``) that start inside a
``loans.feed`` or ``loans.train.call`` span, per traced training step."""

from perfbench.spans import syncs_per


def read(ctx):
    return syncs_per(ctx, {"loans.feed", "loans.train.call"}, "steps")
