"""Share of the traced stretch in which no kernel, copy or set ran on the
device (the union of their intervals from torch.profiler)."""

from pb.readers import idle_share


def read(record):
    return idle_share(record)
