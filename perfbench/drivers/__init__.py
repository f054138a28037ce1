"""One general driver per kind of traffic; a traffic file names its driver
(``"driver": "<module>"``) and holds every parameter the driver reads.

A driver module defines ``Driver(cell, seed, device)`` with ``setup()``
(leaving ``phases``, a ``core.Phases`` of its set-up), ``window(seconds)``
(a dict of ``attempted``, ``failed``, the end-to-end ``metrics`` and a
``diag`` printed on standard error), ``trace_info()`` (the traced window's
``units``, ``counters`` and ``shapes``), ``release()``, ``judge()`` (the
numbers compared with the reference) and ``control_judge()`` (the same
numbers with the control, the reference in a lower precision, in the
program's place).
"""
