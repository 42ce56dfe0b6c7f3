"""submit_host_ms: host milliseconds of a ``ConvStream.submit`` call into a
queue with room, the mean over the traced window (host clock around each
call; the profiler's own cost on the host is inside it)."""


def read(rec: dict) -> float | None:
    s = rec["submit_host_s"]
    return 1e3 * sum(s) / len(s) if s else None
