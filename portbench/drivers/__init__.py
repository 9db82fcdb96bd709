"""Drivers, one module a loop, found by the name a traffic file gives for
its configuration's entry path.  Each has make(setting) -> an object with
step() -> [Done] and drain() -> [Done] (portbench.loops)."""
