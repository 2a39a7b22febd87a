"""PyTorch/CUDA port of adaptive_tpu: adaptive-attention image captioning on
an NVIDIA Hopper card.

The layout mirrors ``adaptive_tpu`` module for module. The port imports
torch, numpy and the standard library only; it never imports JAX or the JAX
package. Entry points run on ``device="cuda"`` unless the caller asks for the
CPU, where every kernel wrapper runs its plain PyTorch twin.
"""

from adaptive_tpu_torch.config import Config

__all__ = ["Config"]
