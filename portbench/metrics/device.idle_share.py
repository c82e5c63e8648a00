"""Share of the profiled slice's wall time in which no kernel, memcpy or
memset ran on the card: 1 - (union of the device intervals) / (the
slice's length)."""


def read(rec):
    sl = rec.get("slice")
    if not sl or sl["busy_s"] <= 0 or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
