"""Share of K4's roofline (the training BiLSTM recurrence, which keeps
the backward residuals) over the traced stretch of train steps."""

from pb.readers import lstm_roofline


def read(record):
    return lstm_roofline(record, "bilstm_recurrence_train", "rec_train")
