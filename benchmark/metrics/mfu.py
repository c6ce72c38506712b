"""Model FLOPs of the traced window's steps (``benchmark.flops``) over the
card's busy time in that window (the union of its kernels, copies and
sets, from the trace), as a share of the card's published peak in the
configuration's compute type: how fast the step runs on the card,
leaving out the time the card waited for the host or for data."""

_PEAK_KEY = {"bfloat16": "bf16_flops", "float16": "bf16_flops",
             "float32": "fp32_flops"}


def read(run):
    if run.peaks is None or run.trace is None or not run.traced_steps:
        return None
    if run.trace.busy_s <= 0:
        return None
    peak = run.peaks[_PEAK_KEY[run.config["compute_dtype"]]]
    return 100.0 * run.step_flops * run.traced_steps / run.trace.busy_s / peak
