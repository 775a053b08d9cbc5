"""One process on the first card, one client: each query is called once
the one before it has returned and the device has synchronized."""

import torch

from portbench import harness


def run(cell, seed: int, seconds: float, trace: bool, t_start: float):
    return harness.run_cell(cell, seed, seconds, trace,
                            torch.device("cuda", 0), t_start)
