"""Milliseconds a step of the consumer's integrity check of its windows
(the port's ``ddl.integrity_verify`` range) in the traced window."""

from benchmark.metrics import _host_spans


def read(run):
    return _host_spans.per_step_ms(run, "ddl.integrity_verify")
