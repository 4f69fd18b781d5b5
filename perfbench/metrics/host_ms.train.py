"""Host milliseconds a traced training step spends issuing its work:
the time inside ``loans.train.call`` spans less the part of it spent in
synchronising and copy calls."""

from perfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, {"loans.train.call"}, "steps")
