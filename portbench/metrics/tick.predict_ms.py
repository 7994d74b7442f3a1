"""Device milliseconds of a replayed tick's ``tick.predict`` phase (the
predicted rollout, the packing, the failure mask and reset): the median
over the traced call's read replays of the graph's own timing events
(``CUDAGraphTick.phase_ms``, ``phases.py``)."""

from portbench import phases


def read(record):
    return phases.median_ms(record, "tick.predict")
