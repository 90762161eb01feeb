"""Fault-tolerance supervisor: launch a training command, poll it, and
relaunch it when it fails; the trainer resumes from its own latest
checkpoint. Counterpart of reed_tpu/monitor.py (reference:
molecule/scripts/monitor.py:29-120). Works with every `reed_tpu_torch.cli
train-*` command run with `--ckpt-dir D --ckpt-every N`, since each resumes
from D's latest `{step}.pt` (core/checkpoint.py).

  python -m reed_tpu_torch.monitor --interval 60 --max-restarts 100 \\
      -- python -m reed_tpu_torch.cli train-image --ckpt-dir out/run1 \\
         --ckpt-every 500 --steps 100000 --synthetic
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

from reed_tpu_torch.core.checkpoint import _NAME


def latest_checkpoint_step(ckpt_dir: Optional[str]) -> Optional[int]:
    """The newest step with a `{step}.pt` checkpoint in `ckpt_dir`, or None."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def monitor(command: Sequence[str], interval: float = 60.0, max_restarts: int = 100,
            ckpt_dir: Optional[str] = None) -> int:
    """Run `command`; on a non-zero exit relaunch it (at most max_restarts
    times), after `interval` seconds. Returns the last exit code."""
    command = list(command)
    if ckpt_dir is None and "--ckpt-dir" in command:
        ckpt_dir = command[command.index("--ckpt-dir") + 1]
    restarts = 0
    while True:
        start_step = latest_checkpoint_step(ckpt_dir)
        print(f"[monitor] launching (restart {restarts}, latest checkpoint step: "
              f"{start_step}): {' '.join(command)}", flush=True)
        proc = subprocess.Popen(command)
        try:
            while proc.poll() is None:
                time.sleep(interval)
        except KeyboardInterrupt:
            proc.send_signal(signal.SIGINT)
            proc.wait()
            return proc.returncode
        code = proc.returncode
        if code == 0:
            print("[monitor] training finished cleanly", flush=True)
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[monitor] giving up after {restarts - 1} restarts (last exit code "
                  f"{code})", flush=True)
            return code
        new_step = latest_checkpoint_step(ckpt_dir)
        progress = new_step is not None and (start_step is None or new_step > start_step)
        print(f"[monitor] process died with code {code}; progress since launch: {progress} "
              f"(checkpoint step {new_step}); relaunching in {interval:.0f} s", flush=True)
        time.sleep(interval)


def main(argv=None):
    parser = argparse.ArgumentParser("reed_tpu_torch.monitor")
    parser.add_argument("--interval", type=float, default=60.0)
    parser.add_argument("--max-restarts", type=int, default=100)
    parser.add_argument("--ckpt-dir", default=None,
                        help="default: the command's own --ckpt-dir")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command, after --")
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no training command given (put it after --)")
    sys.exit(monitor(command, args.interval, args.max_restarts, args.ckpt_dir))


if __name__ == "__main__":
    main()
