"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
H100 SXM: float32 outside the tensor cores, HBM3 bandwidth; at the card's
full 700 W power limit)."""

PEAKS = {
    "H100": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_of(device_name):
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
