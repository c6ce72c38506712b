"""Milliseconds of producer work a window: the refill and the copy,
stamp and commit (the port's ``producer.fill`` and ``producer.stamp``
ranges) summed over every producer thread in the traced window, over the
windows they stamped there."""

from benchmark.metrics import _host_spans


def read(run):
    stamps = _host_spans.durations(run, "producer.stamp")
    fills = _host_spans.durations(run, "producer.fill")
    if not stamps or not fills:
        return None
    return 1e3 * (sum(fills) + sum(stamps)) / len(stamps)
