"""Forward model operations of the real frames served by the pipeline
calls that began in the window, over those calls' summed wall time,
against the bf16 dense peak."""

from pb import roofline
from pb.readers import calls_in_window, mfu


def read(record):
    calls = calls_in_window(record)
    if not calls:
        return None
    frames = sum(c["frames"] for c in calls)
    seconds = sum(c["end_ns"] - c["start_ns"] for c in calls) / 1e9
    return mfu(roofline.flops_per_frame(record["config"]) * frames, seconds)
