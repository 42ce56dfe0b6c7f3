"""mac_ms: device milliseconds a frame of the spectral MAC kernels
(``csrc/spectral_mac.cu``: ``spectral_mac_kernel``, ``spectral_mac_split_kernel``)."""

import re

PATTERN = re.compile(r"spectral_mac")


def read(rec: dict) -> float | None:
    us = [e - s for n, s, e in rec["kernels"] if PATTERN.search(n)]
    if not us or not rec["frames"]:
        return None
    return sum(us) * 1e-3 / rec["frames"]
