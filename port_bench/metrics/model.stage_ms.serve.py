"""Mean device milliseconds of the model stage a pipeline call (CUDA
events around FusedAcousticPipeline.model_stage), serving."""

from pb.readers import mean_ms


def read(record):
    return mean_ms(record, "model_ms") if "calls" in record else None
