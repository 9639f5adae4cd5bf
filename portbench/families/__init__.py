"""Model families, one file each, found by a configuration's ``family``.

A family's file is where the benchmark reaches the program for that
family. It has ``WIDTHS`` (each published width of a configuration file ->
the program's config field that must equal it at full size),
``matmul_params(spec)`` (the parameters that multiply an activation, for
``yardstick.model_flops``), the entry points its drivers call (for a
model that is not served, ``forward(cfg) -> f(params, inputs)``) and
``FAULTS`` (fault name -> a function returning the context that plants it
in the program; ``faults.py`` holds those that no family owns).
"""
