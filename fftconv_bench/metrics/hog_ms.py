"""hog_ms: milliseconds between CUDA events recorded around the benchmark's
call of the port's ``hog_features`` (with the cast to the features' dtype),
the mean over the traced window's frames. Nothing to read in a cell with no
HOG front end."""


def read(rec: dict) -> float | None:
    t = rec["hog_ms"]
    return sum(t) / len(t) if t else None
