"""Percent of the profiled replays' wall time in which no operation ran
on the device: 1 - the union of the device operations' intervals over the
synchronised span of the replays."""


def read(record):
    if record.get("driver") != "lanes_fleet" or not record.get("busy_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
