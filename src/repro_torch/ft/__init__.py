"""Fault tolerance (port of ``repro.ft``, DESIGN.md §11): deterministic
fault injection (``ft.chaos``), runtime invariant guards and the repair
lattice (``ft.invariants``), and the runtime: the transient-retry
envelope, straggler and heartbeat policies, remesh planning, mid-fit
checkpoints and a restart-safe step loop (``ft.runtime``)."""
from .chaos import FaultInjector, Preemption, TransientError, poisson_trace
from .chaos import active as active_injector
from .runtime import (FaultTolerantLoop, FitCheckpointer, HeartbeatMonitor,
                      StragglerPolicy, plan_remesh, retry_transient)

__all__ = ["FaultInjector", "FaultTolerantLoop", "FitCheckpointer",
           "HeartbeatMonitor", "Preemption", "StragglerPolicy",
           "TransientError", "active_injector", "plan_remesh",
           "poisson_trace", "retry_transient"]
