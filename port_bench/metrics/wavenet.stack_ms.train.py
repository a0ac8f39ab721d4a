"""Mean device milliseconds of the WaveNet's residual blocks a train
step (the program's ``wavenet.stack`` span: the forward of the blocks,
CUDA events on the step's stream)."""

from pb.program_spans import mean_device_ms


def read(record):
    return mean_device_ms(record, "wavenet.stack")
