"""Percent of the card's f32 peak that a whole replayed lanes tick reaches:
the plain reference's count of one tick's operations at the cell's batch
over the replayed tick's wall time (the profiled span over the replays)
at 67 TFLOP/s. It bounds what a kernel's own roofline share can give the
fleet."""

from portbench.count import PEAK_F32


def read(record):
    cost = record.get("tick_cost")
    if (record.get("driver") != "lanes_fleet" or not cost
            or not record.get("busy_s")):
        return None
    return 100.0 * cost["flops"] / (PEAK_F32 * record["window_s"]
                                    / record["ticks"])
