"""Drivers, one per kind of traffic. A traffic file names its driver.

Each driver module has ``setup(ctx) -> state`` (weights, program objects,
warm-up of every shape the window uses), ``window(ctx, state) -> record``
(the measured window: ``units``, ``window``, ``attempted``, ``failed``),
``release(ctx, state, record) -> kept`` (drop the program's state, keep
what the check reads), ``check(ctx, record, kept) -> {number: value}``,
``control(ctx) -> {number: value}`` and ``faults(ctx)``, the names of
the faults its cells can have (each in the ``FAULTS`` of the cell's
``families/<family>.py``).

A unit is one step or one request: ``t0``, ``t1`` (host clock), ``tokens``
(tokens or mesh points of completed work), ``model_flops``, ``attn`` and,
for requests, ``latency``. ``attn`` is the work ``{"flops", "bytes"}`` of
the unit's attention calls (``yardstick.attention_call``): one work that
every call has, or a list of works, one per call in the order the calls
start (``readers.call_works`` pairs them with the program's spans).
"""
