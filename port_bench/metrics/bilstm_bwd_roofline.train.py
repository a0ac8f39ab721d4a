"""Share of K5's roofline (csrc/bilstm_bwd.cu, the reverse-time backward
of a BiLSTM layer) over the traced stretch of train steps."""

from pb.readers import lstm_roofline


def read(record):
    return lstm_roofline(record, "bilstm_bwd", "bwd")
