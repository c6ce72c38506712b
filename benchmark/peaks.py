"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), looked up by ``torch.cuda.get_device_name``."""

from __future__ import annotations

from typing import Dict, Optional

#: NVIDIA H100 data sheet: the SXM part at its 700 W limit.
PEAKS = (
    ("H100 80GB HBM3", {"bf16_flops": 989e12, "fp8_flops": 1979e12,
                        "tf32_flops": 495e12, "fp32_flops": 67e12,
                        "hbm_bytes_per_s": 3.35e12}),
)


def lookup(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table lacks."""
    for key, peaks in PEAKS:
        if key in device_name:
            return peaks
    return None
