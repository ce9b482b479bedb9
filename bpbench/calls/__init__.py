"""The calls into the program, one module per name in a traffic mix's
``calls``, run in that order once a frame.

Each module has ``SPAN`` (the name of the span the harness wraps around
the call), ``prepare(cell)`` (set-up, outside every timed frame) and
``run(cell, frame, out)``, which puts the call's results into ``out``
under ``tree`` (a ``LayerState``), ``pairs`` (a ``ScanResult``) or
``pick`` (a ``PickResult``), the kinds ``check.py`` compares with the
reference.
"""
