"""Milliseconds a step the trainer's thread spent in the port's
``ddl.step_dispatch`` range in the traced window: the host's enqueue of
a window's steps, including any time it blocked on a full launch queue.
Once the launch queue fills, that block is the card's step showing
through, so read it together with ``ddl.loss_readback``: their sum is
about one step, and only the split between them moves with the host."""

from benchmark.metrics import _host_spans


def read(run):
    return _host_spans.per_step_ms(run, "ddl.step_dispatch")
