"""The attention kernels' share of their roofline in the traced window:
the least time the card could take for the attention the steps ask for
(``benchmark.flops.attention_work``, forward and backward of each call,
at the published peaks) over the device time of the kernels that
compute it (the port's flash kernels and their helper passes, by
name)."""

import re

from benchmark import flops

KERNELS = re.compile(r"flash|row_terms|id_range|pad_ids")


def read(run):
    if run.trace is None or run.peaks is None or not run.traced_steps:
        return None
    spent = sum(d for name, cat, _, d, _ in run.trace.ops
                if cat == "kernel" and KERNELS.search(name))
    if spent <= 0:
        return None
    a = run.attention
    work = flops.attention_work(a["batch"], a["seq"], a["heads"],
                                a["kv_heads"], a["head_dim"], a["causal"])
    per_call = sum(flops.bound_s(f, b, run.peaks["bf16_flops"],
                                 run.peaks["hbm_bytes_per_s"])
                   for f, b in work.values())
    return 100.0 * per_call * a["calls"] * run.traced_steps / spent
