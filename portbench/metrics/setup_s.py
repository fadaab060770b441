"""Seconds from the start of the process to the start of the window:
imports, builds, data, the initial state and the warm-up."""


def read(record):
    return record["setup_s"]
