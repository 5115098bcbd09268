"""Numeric policy of the port: float32 everywhere, TF32 off.

The JAX reference computes every device array in float32 and pins its
one-hot value matmuls to full precision (the bf16 truncation fixed in
5c3434a). On the card a float32 matmul or convolution may silently run
in TF32 (about three decimal digits), the same class of fault, so the
port turns TF32 off for both before any tensor work.
"""
import torch


def apply() -> None:
    """Force full-float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


apply()
