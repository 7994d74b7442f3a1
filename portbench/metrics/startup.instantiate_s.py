"""Seconds of the traced call's instantiation of its captured graph
(``graph.instantiate``), from the port's spans (``phases.py``)."""

from portbench import phases


def read(record):
    return phases.span_s(record, "graph.instantiate")
