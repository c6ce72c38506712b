"""Milliseconds a step the consumer waited on a ring for a producer's
commit (the port's ``ddl.ring_wait`` range) in the traced window."""

from benchmark.metrics import _host_spans


def read(run):
    return _host_spans.per_step_ms(run, "ddl.ring_wait")
