"""How a traffic's blocks reach the program: one module per entry, named
by the traffic file's ``entry`` key.  Each has ``make(ctx)`` returning a
runner with ``multiple`` (the window ends on a multiple of that many
blocks), ``warm()``, ``window(win, rec)`` (the closed loop; returns the
last block's outputs as ``checks.compare`` readers, with its ``index``)
and ``free()``; and ``OUTPUTS``, the names of the outputs ``window``
returns, which the control (``control.py``) serves in the program's
place."""
