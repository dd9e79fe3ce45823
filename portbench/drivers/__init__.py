"""The drivers of the measured window, one module a mix ``entry``.

The harness imports ``drivers/<entry>.py`` by the ``entry`` of the
cell's mix file and builds its ``Driver(config, mix, seed, device,
mark)``: the driver builds the program and its inputs from the
configuration file and the seed, calling ``mark(name)`` at the end of
each phase of its set-up.  A driver has:

* ``label``: the name of the time inside a call that no host span
  covers (an idle gap's name in the traced ``breakdown``);
* ``warmup_calls``: calls run before the window, in set-up;
* ``side``: the CUDA stream of the benchmark's own device work, or
  ``None``; its kernels are not the program's;
* ``bound_s``: the frozen work bound of one call (``roofline.py``), or
  ``None``;
* ``call(k) -> (output, items)``: the ``k``-th call of the program, its
  device work finished when it returns;
* ``keep(k, output)``: what the check needs of a call, off the window's
  clock;
* ``release()``: drop the program's state once the window has closed;
* ``check() -> (checks, attempted, failed)``: the outputs against
  ``reference.py``, ``checks`` as ``{name: (value, limit)}``;
* ``control()``: a context in which the reference's control stands in
  the program's place;
* ``span_targets()``: the program's public entries that a traced run
  times, as ``(owner, attribute, span, waits)``; ``waits`` adds a
  ``wait`` span for the device work the entry enqueued.

A later mix whose window drives another entry of the program adds a
driver file; nothing else changes.
"""
