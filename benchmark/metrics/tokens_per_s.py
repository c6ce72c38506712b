"""Tokens trained over the measured window's host-clock time."""


def read(run):
    if run.item_unit != "tokens":
        return None
    return run.items_per_step * run.measured_steps / run.prog.window_s
