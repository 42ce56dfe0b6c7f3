"""block_conv_ms: device milliseconds a frame of the fused block-conv
kernels (``csrc/block_conv.cuh`` ``block_conv_kernel``: maps and peaks)."""

import re

PATTERN = re.compile(r"block_conv_kernel")


def read(rec: dict) -> float | None:
    us = [e - s for n, s, e in rec["kernels"] if PATTERN.search(n)]
    if not us or not rec["frames"]:
        return None
    return sum(us) * 1e-3 / rec["frames"]
