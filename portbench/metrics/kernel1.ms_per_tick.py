"""Device milliseconds of kernel 1 (``fused_iteration_kernel``) per
replayed tick, from the profiler's trace."""


def read(record):
    if record.get("driver") != "lanes_fleet" or not record.get("kernel1_s"):
        return None
    return 1e3 * record["kernel1_s"] / record["ticks"]
