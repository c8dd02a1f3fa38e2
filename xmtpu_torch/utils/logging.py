"""Logging of the PyTorch port (counterpart of ``xmtpu.utils.logging``):
stdlib logging under the ``xmtpu_torch.*`` namespace. Per-run metrics
live on the batch runner's ``BatchReport``."""

from __future__ import annotations

import logging


def get_logger(name: str = "xmtpu_torch") -> logging.Logger:
    """The logger ``name``, after giving the package's root logger one
    stderr handler at INFO (once). The handler sits on the package root,
    never on a child, so a child configured first does not emit its
    records twice; the root stops propagating to the global root, so an
    application's ``basicConfig()`` does not double them either (clear
    the handlers and re-enable propagation to take over)."""
    root = logging.getLogger("xmtpu_torch")
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logging.getLogger(name)
