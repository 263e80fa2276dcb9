"""CPU tests of the benchmark harness (``python -m pytest benchmark/tests``):
the seeded pool, the files found by name, the metric readers on synthetic
traces, the import guard, the plain reference against the port, and
``correct`` on sound, control and broken runs at a small size."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)
