"""The benchmark of ``limg_tpu_torch`` on an NVIDIA H100 (``run.py``).

Everything of one cell, configuration, traffic family, per-layer metric or
kernel count sits in a file of its own, found by its name:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by ``traffic/<generator>.py``),
``metrics/<metric>.py``, ``counts/<kernel>.py`` and ``entries/<entry>.py``.
``reference/`` is the frozen plain route that decides ``correct``.
"""
