"""Model operations of the real samples trained (three times the forward
operations a sample, ``pb/wavenet_model.py``) over the window's wall
time, against the bf16 dense peak of the card."""

from pb import wavenet_model
from pb.readers import mfu


def read(record):
    if "steps" not in record or "num_layers" not in record["config"]:
        return None
    flops = 3 * wavenet_model.flops_per_sample(record["config"]) \
        * record["frames"]
    return mfu(flops, record["window_s"], record["chips"])
