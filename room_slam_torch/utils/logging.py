"""Append-only JSONL metrics log (counterpart of the JAX package's
``utils/logging.py::MetricsLogger``)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics sink: one line per ``log`` call, with the
    wall seconds since the logger was made."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, **metrics: float) -> None:
        if not self.path:
            return
        rec: Dict = {"wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
