"""Frozen work counts of the port's kernels, from shapes and counts.

``counts/<kernel>.py`` (or ``counts/<family>.py`` for ``<family>_p<P>``)
has ``bound_s(kernel, job)``: the least time one image's calls of that
kernel could take on the card (``common.call_bound``), or None where the
counts do not cover the call. Copied from ``chip_smoke.py``'s
``kernel_bound`` and the functions it uses, rewritten to take a ``Job``
(the frame, the configuration, the content's counts) in place of the
port's tensors.
"""
