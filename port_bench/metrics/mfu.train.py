"""Model operations of the real frames trained (three times the forward
operations a frame) over the window's wall time, against the bf16 dense
peak of every card the run uses."""

from pb import roofline
from pb.readers import mfu


def read(record):
    if "steps" not in record:
        return None
    flops = 3 * roofline.flops_per_frame(record["config"]) * record["frames"]
    return mfu(flops, record["window_s"], record["chips"])
