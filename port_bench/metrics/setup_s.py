"""Set-up seconds: process start to the first timed unit (loading,
warming up, and the checked first steps of a training run)."""


def read(record):
    return record.get("setup_s")
