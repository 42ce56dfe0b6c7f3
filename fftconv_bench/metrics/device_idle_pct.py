"""device_idle_pct: 100 × (1 − busy / span) over the traced window, busy
the union of the device's kernel and copy spans, span the first start to
the last end."""


def read(rec: dict) -> float | None:
    if rec["span_us"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_us"] / rec["span_us"])
