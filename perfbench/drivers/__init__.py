"""One driver per traffic kind, found by a traffic file's ``kind``: its
``run(cell, conf, traffic, limits, seed, seconds, trace, t_proc, log,
device=, fault=)`` makes the inputs, runs the set-up and the window, checks
the output and returns the result line's parts (``setup_s``, ``e2e``,
``attempted``, ``failed``, ``peak``, ``ctx``, ``stretch``, ``compared``,
``correct``).  A later kind, such as training, is a new module here."""
