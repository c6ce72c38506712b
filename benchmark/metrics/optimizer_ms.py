"""Device time per step of the kernels launched inside the optimizer's
step (the host range ``Optimizer.step#...`` that ``torch.optim`` opens),
in the traced window."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    launched = run.trace.launched_in.get(r"^Optimizer\.step", set())
    times = [d for _, _, _, d, corr in run.trace.ops if corr in launched]
    if not times:
        return None
    return 1e3 * sum(times) / run.traced_steps
