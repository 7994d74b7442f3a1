"""Device operations (kernels, copies, fills) per replay of the lanes
tick's CUDA graph, inputs copied in and outputs cloned included, from the
profiler's trace."""


def read(record):
    if record.get("driver") != "lanes_fleet" or not record.get("device_ops"):
        return None
    return record["device_ops"] / record["ticks"]
