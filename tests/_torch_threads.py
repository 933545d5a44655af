"""Caps torch's intra-op threads in a test process at its share of the cores.

Under pytest-xdist every worker is a process of its own, and torch gives
each one a thread per core: six workers on eight cores run ~48 intra-op
threads that contend for the cores, and the port's CPU runs (the Trainer's
steps, the reduced models' forwards and backwards) slow down several times
over.  Importing this module sets `torch.set_num_threads` to the cores over
the workers (`PYTEST_XDIST_WORKER_COUNT`, 1 without xdist), at least 1.  It
changes no check, bound or data: only how many threads compute the same
results.  The port's test files import it first.
"""
import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
