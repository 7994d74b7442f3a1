"""Percent of the roofline kernel 1 reaches: the least time its work could
take on the card (the plain reference's count of its operations at the f32
peak, or of its bytes at the HBM peak, the larger) over its measured
device time per launch."""

from portbench.count import roofline_share


def read(record):
    cost = record.get("kernel1_cost")
    if (record.get("driver") != "lanes_fleet" or not cost
            or not record.get("kernel1_s")):
        return None
    return roofline_share(cost["flops"], cost["bytes"],
                          record["kernel1_s"] / record["ticks"])
