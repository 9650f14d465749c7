"""Run-directory metrics: a JSON-lines stream, a text log and, when asked
for (`tensorboard=True`; its import pulls in TensorBoard's own packages,
seconds of start-up), TensorBoard scalars.

The reference's `Logger`: running means flushed every SUM_FREQ = 100 steps
(with steps a second), validation results written as they come, the
experiment's YAML copied into the run directory.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
import time
from typing import Dict, Optional


class MetricsLogger:
    SUM_FREQ = 100

    def __init__(self, log_dir: str, config_path: Optional[str] = None,
                 name: str = "run", tensorboard: bool = False):
        ts = datetime.datetime.now().strftime("%b%d_%H-%M-%S")
        self.log_dir = os.path.join(log_dir, f"{ts}_{name}")
        os.makedirs(os.path.join(self.log_dir, "checkpoints"), exist_ok=True)
        if config_path and os.path.exists(config_path):
            shutil.copyfile(config_path, os.path.join(self.log_dir, "config.yaml"))

        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self._running: Dict[str, float] = {}
        self.total_steps = 0
        self._t0 = time.time()

        self.logger = logging.getLogger(f"focusflow_torch.{name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self._handler = logging.FileHandler(os.path.join(self.log_dir, "train.log"))
        self._handler.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
        self.logger.addHandler(self._handler)

        self._tb = None
        if tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=self.log_dir)

    def push(self, metrics: Dict[str, float]) -> None:
        self.total_steps += 1
        for k, v in metrics.items():
            self._running[k] = self._running.get(k, 0.0) + float(v)
        if self.total_steps % self.SUM_FREQ == self.SUM_FREQ - 1:
            means = {k: v / self.SUM_FREQ for k, v in self._running.items()}
            means["steps_per_sec"] = self.SUM_FREQ / max(time.time() - self._t0, 1e-9)
            self.write_dict(means, prefix="train/")
            self._running = {}
            self._t0 = time.time()

    def write_dict(self, results: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": self.total_steps, **{prefix + k: v for k, v in results.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self.logger.info(json.dumps(rec))
        if self._tb is not None:
            for k, v in results.items():
                self._tb.add_scalar(prefix + k, v, self.total_steps)

    def info(self, msg: str) -> None:
        self.logger.info(msg)

    def close(self) -> None:
        self._jsonl.close()
        self.logger.removeHandler(self._handler)
        self._handler.close()
        if self._tb is not None:
            self._tb.close()
