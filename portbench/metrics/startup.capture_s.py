"""Seconds of the traced call's CUDA-graph capture of its tick
(``graph.capture``), from the port's spans (``phases.py``)."""

from portbench import phases


def read(record):
    return phases.span_s(record, "graph.capture")
