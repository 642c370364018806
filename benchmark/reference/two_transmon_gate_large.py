"""Reference of the two-transmon gate at a large truncation: the plain
PyTorch reference of ``two_transmon_gate`` (complex128, TF32 off, autograd
through ``torch.linalg.matrix_exp``, no series of the program's), with the
autograd window cut to fit the card.

At dim 1024 the backward pass of ``matrix_exp`` exponentiates the
``(steps, 2048, 2048)`` block matrices of its window in complex128, 64 MiB
each, with several such tensors alive at once; 25 steps a window keep that
within a fifth of one H100's memory.  A window is a sum of its steps'
terms, so the gradient is the same for any window."""

import torch

from . import two_transmon_gate as base

__all__ = ["Reference", "blocks", "combine", "WINDOW_ITEMS"]

blocks = base.blocks
combine = base.combine

# steps times samples in one autograd window
WINDOW_ITEMS = 25


class Reference(base.Reference):
    def __init__(self, config, inputs, device, dtype=torch.complex128,
                 tf32=False, window_items=WINDOW_ITEMS):
        super().__init__(config, inputs, device, dtype=dtype, tf32=tf32,
                         window_items=window_items)
