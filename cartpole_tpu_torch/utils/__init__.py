"""Observability and persistence: tracing, structured solve logs,
checkpoints, debug checks and the roofline (counterpart of
``cartpole_tpu/utils``): mini_opt's Chrome-trace collector becomes a host
collector plus ``torch.profiler``; the web app's JSON solve log becomes
:class:`SolveLog`; the implicit "warm start == resumable state" contract
becomes explicit checkpoint save/load of solver-state trees.
"""

from .checkpoint import (
    load_state,
    load_state_dcp,
    save_state,
    save_state_dcp,
)
from .debug import (
    DebugCheckError,
    assert_all_finite,
    checked,
    debug_mode,
    leak_check,
)
from .logging import SolveLog, solve_log_entry, solver_summary
from .replay import LogReplay, load_log, replay_log
from .tracing import (
    TraceCollector,
    get_trace_json,
    is_tracing_enabled,
    join_traces,
    profiler_trace,
    set_tracing_enabled,
    trace_scope,
)

__all__ = [
    "LogReplay",
    "SolveLog",
    "TraceCollector",
    "get_trace_json",
    "is_tracing_enabled",
    "join_traces",
    "leak_check",
    "load_log",
    "load_state",
    "load_state_dcp",
    "replay_log",
    "profiler_trace",
    "save_state",
    "save_state_dcp",
    "set_tracing_enabled",
    "solve_log_entry",
    "solver_summary",
    "trace_scope",
]
