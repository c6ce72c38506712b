"""95th percentile of the step times of the measured window: CUDA events
recorded on the card's stream at every window hook, so a step's time
includes any wait of the card for its data."""

import numpy as np


def read(run):
    gaps = run.prog.window_gaps_s
    if not gaps:
        return None
    steps = np.asarray(gaps, dtype=np.float64) / run.steps_per_window
    return float(np.percentile(steps, 95) * 1e3)
