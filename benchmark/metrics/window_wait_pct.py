"""Share of the measured window the trainer loop spent waiting for its
next window (the port's ``trainer.window_wait`` timer)."""


def read(run):
    return 100.0 * run.prog.wait_s / run.prog.window_s
