"""Host milliseconds a traced served batch spends in the serving entry
(``loans.serve.batch`` spans) less the part of it spent in synchronising
and copy calls."""

from perfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, {"loans.serve.batch"}, "batches")
