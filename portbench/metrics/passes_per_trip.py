"""Tier-2 passes per batched trip (``ops/fused_pass.py::leaf_apply``;
``RunInfo.n_outer_trips`` over ``n_inner_trips``)."""


def read(record):
    c = record["counters"]
    return c["passes"] / c["trips"] if c["trips"] else None
