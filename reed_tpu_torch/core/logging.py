"""Metric logging to stdout and JSONL with step rates, counterpart of
reed_tpu/core/logging.py's MetricLogger (no wandb in the port)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """`log(metrics, step)` prints `[step N] {...}` and appends a JSON line
    to `log_dir`/metrics.jsonl when a directory is given. From the second
    call on it adds steps_per_sec (and samples_per_sec given
    samples_per_step) over the steps since the previous call. Reading the
    metrics as floats waits for the device."""

    def __init__(self, log_dir: Optional[str] = None, stdout: bool = True):
        self.stdout = stdout
        self.jsonl = None
        self._t_last = None
        self._step_last = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict, step: int, samples_per_step: Optional[int] = None):
        metrics = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        if self._t_last is not None and step > self._step_last:
            dt = now - self._t_last
            steps = step - self._step_last
            metrics["steps_per_sec"] = steps / dt
            if samples_per_step:
                metrics["samples_per_sec"] = steps * samples_per_step / dt
        self._t_last, self._step_last = now, step
        if self.stdout:
            print(f"[step {step}] { {k: round(v, 5) for k, v in metrics.items()} }",
                  flush=True)
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, **metrics}) + "\n")
            self.jsonl.flush()
        return metrics

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
