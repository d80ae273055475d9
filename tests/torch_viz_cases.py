"""Helpers of the plot tests: what a matplotlib figure draws, as data, and
a recorder of the figures that ``savefig`` writes."""

from pathlib import Path

import numpy as np
from matplotlib.collections import LineCollection
from matplotlib.figure import Figure
from matplotlib.patches import Rectangle


def figure_data(fig):
    """Per axes: title, axis labels, each line's data (3D lines' too), each
    rectangle's corner and size, each collection's offsets (segments for a
    line collection) and each text with its position; and the suptitle."""
    axes = []
    for ax in fig.axes:
        lines = [np.asarray(ln.get_data_3d() if hasattr(ln, "get_data_3d")
                            else ln.get_xydata(), dtype=float)
                 for ln in ax.lines]
        rects = [np.asarray([*p.get_xy(), p.get_width(), p.get_height()],
                            dtype=float)
                 for p in ax.patches if isinstance(p, Rectangle)]
        colls = [np.concatenate([np.asarray(s, float).ravel()
                                 for s in c.get_segments()] or [[]])
                 if isinstance(c, LineCollection)
                 else np.asarray(c.get_offsets(), dtype=float)
                 for c in ax.collections]
        texts = [(t.get_text(), np.asarray(t.get_position(), dtype=float))
                 for t in ax.texts]
        axes.append({"title": ax.get_title(), "xlabel": ax.get_xlabel(),
                     "ylabel": ax.get_ylabel(), "lines": lines,
                     "rects": rects, "colls": colls, "texts": texts})
    sup = fig._suptitle.get_text() if fig._suptitle is not None else None
    return {"suptitle": sup, "axes": axes}


def assert_same_figure(got, ref, atol=1e-6):
    """Structure and strings exactly, coordinates within ``atol``."""
    assert got["suptitle"] == ref["suptitle"]
    assert len(got["axes"]) == len(ref["axes"])
    for a, b in zip(got["axes"], ref["axes"]):
        for k in ("title", "xlabel", "ylabel"):
            assert a[k] == b[k], (k, a[k], b[k])
        for k in ("lines", "rects", "colls"):
            assert len(a[k]) == len(b[k]), (b["title"], k)
            for x, y in zip(a[k], b[k]):
                assert x.shape == y.shape, (b["title"], k)
                np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                           err_msg=f"{b['title']}: {k}")
        assert [t for t, _ in a["texts"]] == [t for t, _ in b["texts"]]
        for (_, p), (_, q) in zip(a["texts"], b["texts"]):
            np.testing.assert_allclose(p, q, rtol=0, atol=atol)


def record_savefig(monkeypatch):
    """Patch ``Figure.savefig`` to record ``figure_data`` by file name
    before writing the file (at 10 dpi: the tests read the data, and
    rendering at the scripts' 110-150 dpi takes seconds); returns the
    record dict."""
    record = {}
    orig = Figure.savefig

    def savefig(self, fname, *args, **kwargs):
        record[Path(str(fname)).name] = figure_data(self)
        return orig(self, fname, *args, **{**kwargs, "dpi": 10})

    monkeypatch.setattr(Figure, "savefig", savefig)
    return record
