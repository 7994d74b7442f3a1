"""Seconds of the traced call's eager start-up: tick 0 run eagerly
(``lanes.eager_tick``) and tick 1's eager warm-up before the capture
(``graph.warmup``), from the port's spans (``phases.py``)."""

from portbench import phases


def read(record):
    return phases.span_s(record, "lanes.eager_tick", "graph.warmup")
