"""The plain reference of the benchmark: frozen copies of the port's plain
PyTorch modules (models, integrators, the per-instance solver, the plain
version of the fused lanes iteration, the controller, the plant), taken at
the commit that added the benchmark and trimmed to what a tick needs. It
imports nothing of the port, so a later change to the port cannot move the
yardstick it is judged by."""
