"""Fault tolerance (port of ``repro.ft``): so far the invariant counters
and the drift guard of the streaming model (``ft.invariants``); the
chaos injector, the fit-time guards and the retry envelope wait for
ROADMAP §1 item 9."""
