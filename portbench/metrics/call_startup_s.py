"""Seconds of a synchronised 2-tick call of the lanes entry at the cell's
shapes: tick 0 eager, then tick 1's eager warm-up, capture and
instantiation (host clock)."""


def read(record):
    if record.get("driver") != "lanes_fleet":
        return None
    return record.get("call_startup_s")
