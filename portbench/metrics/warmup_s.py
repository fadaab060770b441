"""Wall seconds of the job's fixed warmup, ending on a device synchronize:
the time to the first draw."""


def read(record):
    if not record["counters"]["sampling_iters"]:
        return None
    return record["warmup_s"]
