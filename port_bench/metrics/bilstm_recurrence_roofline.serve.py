"""Share of K3's roofline (the inference BiLSTM recurrence,
csrc/bilstm_recurrence.cu) over the traced stretch of pipeline calls:
three launches a call, each over the call's padded rows and length."""

from pb.readers import lstm_roofline


def read(record):
    return lstm_roofline(record, "bilstm_recurrence", "rec")
