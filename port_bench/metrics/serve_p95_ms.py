"""95th percentile latency of every request due in the window, from
when it was due to when its waveform came back (open loop); a request
that failed or never came counts with the time the run waited for it."""

from pb.readers import p95_ms


def read(record):
    return p95_ms(record.get("latency_s"))
