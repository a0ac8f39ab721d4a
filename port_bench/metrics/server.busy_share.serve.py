"""Share of the window the server's dispatch thread spent inside
pipeline calls (host clock around each call, which ends in the copy of
the waveforms to the host)."""


def read(record):
    if "calls" not in record:
        return None
    w0, w1 = record["window_ns"]
    busy = sum(max(0, min(c["end_ns"], w1) - max(c["start_ns"], w0))
               for c in record["calls"])
    return 100.0 * busy / (w1 - w0)
