"""Device time of the host-to-device copies per step in the traced
window."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    copies = [d for name, cat, _, d, _ in run.trace.ops
              if cat == "gpu_memcpy" and "HtoD" in name]
    if not copies:
        return None
    return 1e3 * sum(copies) / run.traced_steps
