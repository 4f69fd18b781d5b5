"""Synchronising runtime calls (``cuda*Synchronize``) that start inside a
``loans.serve.batch`` span, per traced served batch."""

from perfbench.spans import syncs_per


def read(ctx):
    return syncs_per(ctx, {"loans.serve.batch"}, "batches")
