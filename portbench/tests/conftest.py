"""The benchmark's CPU tests: the checkout's root on sys.path, one intra-op
thread a process (the tiny runs are many small ops)."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)
