"""Training scalars and histograms (port of
gscodec_studio_tpu/utils/logger.py): always a JSON-lines file,
``scalars.jsonl`` in the log directory, and TensorBoard events beside it
when ``torch.utils.tensorboard`` imports. Its writer is opened at the
first record, so that a run that logs nothing does not import it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class TrainLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        self._tb_wanted = True
        self._t0 = time.time()

    def _writer(self):
        if self._tb_wanted:
            self._tb_wanted = False
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.log_dir)
            except Exception:  # no tensorboard: the JSON lines only
                self._tb = None
        return self._tb

    def scalars(self, values: Dict[str, float], step: int):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        tb = self._writer()
        if tb is not None:
            for k, v in values.items():
                tb.add_scalar(k, float(v), step)

    def histogram(self, tag: str, values, step: int, bins: int = 64):
        v = np.asarray(values).reshape(-1)
        hist, edges = np.histogram(v, bins=bins)
        self._f.write(json.dumps({
            "step": int(step), "hist": tag,
            "counts": hist.tolist(),
            "lo": float(edges[0]), "hi": float(edges[-1]),
        }) + "\n")
        self._f.flush()
        tb = self._writer()
        if tb is not None:
            tb.add_histogram(tag, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
