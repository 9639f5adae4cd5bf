"""Drivers, one per kind of traffic. A traffic file names its driver.

Each driver module has ``setup(ctx) -> state`` (weights, program objects,
warm-up of every shape the window uses), ``window(ctx, state) -> record``
(the measured window: ``units``, ``window``, ``attempted``, ``failed``),
``release(ctx, state, record) -> kept`` (drop the program's state, keep
what the check reads), ``check(ctx, record, kept) -> {number: value}``,
``control(ctx) -> {number: value}`` and ``faults(ctx)``, the faults of
``portbench/faults.py`` its cells can have.

A unit is one step or one request: ``t0``, ``t1`` (host clock), ``tokens``
(tokens or mesh points of completed work), ``model_flops``, ``attn`` (the
work of each attention call it makes) and, for requests, ``latency``.
"""
