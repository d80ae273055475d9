"""Plots of the port (the JAX package's ``viz/`` and the root
``visualize.py``, ``evaluate.py --visualize`` and ``demo.py --save_viz``).

matplotlib is imported only when a figure is drawn, through ``pyplot``:
the card's machine may have no matplotlib, and the modules that plot on
request (``evaluate``, ``demo``) must import without it.
"""

from __future__ import annotations


def pyplot():
    """matplotlib's ``pyplot`` on the ``Agg`` backend. Raises an
    ``ImportError`` that names matplotlib when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plots need matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def rectangle(*args, **kwargs):
    """``matplotlib.patches.Rectangle`` (imported on first use)."""
    pyplot()
    from matplotlib.patches import Rectangle
    return Rectangle(*args, **kwargs)
