"""Mean host milliseconds a window step waited on the trainer's batch
iterator (its prefetch thread and collate_batch)."""

from pb.readers import mean_ms


def read(record):
    return mean_ms(record, "wait_s", 1e3)
