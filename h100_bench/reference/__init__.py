"""The benchmark's plain reference: float32 PyTorch (TF32 off), no code of
the measured program, used only to judge what the program produced."""

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and matmuls inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
