#!/usr/bin/env python3
"""The one-card GPT-3 1.3B train step of two trees, in turns, on one
NVIDIA GPU:

    python3 chip_compare.py train-turns PARENT_DIR

runs chip_smoke's train step (``phase_train``, then
``phase_train_profile``) from the tree at PARENT_DIR (a ``git archive``
of another commit) and from this one, in turns (parent, this, this,
parent), each in a process of its own, and prints their ``[train]`` and
``[train-profile]`` lines. Needs a CUDA device and exits with another
code than 0 without one.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN_RUN = """
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops import flash_attention as fa
fa.build()
step, ids, _, _ = cs.phase_train(0, torch.device("cuda"))
cs.phase_train_profile(step, ids)
"""


def _say(msg):
    print(msg, flush=True)


def train_turns(parent):
    parent = Path(parent).resolve()
    if not (parent / "chip_smoke.py").exists():
        raise SystemExit(f"{parent} holds no chip_smoke.py")
    failed = False
    for name, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                       ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", TRAIN_RUN], cwd=tree,
                              env=dict(os.environ, PYTHONPATH=str(tree)),
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(("[train]", "[train-profile]")):
                _say(f"<{name}> {line}")
        if proc.returncode:
            _say(f"<{name}> exit {proc.returncode}: {proc.stderr[-3000:]}")
            failed = True
    if failed:
        raise SystemExit("a train run failed")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare.py needs a CUDA device")
    _say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip())
    if argv[:1] == ["train-turns"] and len(argv) == 2:
        train_turns(argv[1])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1:])
