"""The plain reference: PoseNet's tracking window and training step in
``torch.nn.functional`` over flat weight dicts, float32 (the caller turns
TF32 off). It imports nothing of the measured program."""
import contextlib

import torch


@contextlib.contextmanager
def searched_convolutions():
    """cuDNN picks each float32 convolution's algorithm by timing them (on
    the H100 its heuristics pick FFT convolutions for some of RAFT's
    shapes, tens of times slower); the results are unchanged."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev
