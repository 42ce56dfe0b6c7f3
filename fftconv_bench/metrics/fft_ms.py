"""fft_ms: device milliseconds a frame of cuFFT's kernels (the data
spectra and the inverse transforms), from the profiler's kernel names."""

import re

PATTERN = re.compile(r"fft", re.IGNORECASE)
NOT = re.compile(r"block_conv|spectral_mac")


def read(rec: dict) -> float | None:
    us = [e - s for n, s, e in rec["kernels"] if PATTERN.search(n) and not NOT.search(n)]
    if not us or not rec["frames"]:
        return None
    return sum(us) * 1e-3 / rec["frames"]
