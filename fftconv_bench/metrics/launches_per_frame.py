"""launches_per_frame: device kernels in the traced window (copies and
memsets left out) over the frames submitted in it."""


def read(rec: dict) -> float | None:
    if not rec["frames"] or not rec["kernels"]:
        return None
    return len(rec["kernels"]) / rec["frames"]
