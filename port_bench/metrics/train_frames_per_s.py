"""Real (unpadded) frames trained over the window's wall time, whole
steps only; under data parallelism the global batches' frames."""

from pb.readers import rate


def read(record):
    return rate(record, "frames") if "steps" in record else None
