"""conv_roofline: the whole convolution's share of its roofline, in %: the
bound from the cell's shapes alone (``roofline.py``) over the device's busy
milliseconds a frame less the HOG front end's (``hog_ms``, where there is
one). Nothing to read where the device was never busy."""


def read(rec: dict) -> float | None:
    if not rec["frames"] or rec["busy_us"] <= 0:
        return None
    busy_ms = rec["busy_us"] * 1e-3 / rec["frames"]
    hog = rec["hog_ms"]
    conv_ms = busy_ms - (sum(hog) / len(hog) if hog else 0.0)
    if conv_ms <= 0:
        return None
    return 100.0 * rec["roofline"]["bound_ms"] / conv_ms
