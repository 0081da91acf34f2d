"""One CPU thread a test process: the small runs tick against a wall-clock
window, and test processes that each start a full thread pool on a shared
host slow a tick by orders of magnitude."""

import torch

torch.set_num_threads(1)
