"""PyTorch and CUDA port of torchft_tpu, beside the JAX package it is held
against.

This slice covers the device half of the lone-replica train step: the
Llama model (``models.llama``), its fused linear+cross-entropy loss
(``ops.cross_entropy``), flash attention with hand-written Hopper kernels
(``ops.flash_attention``, CUDA sources in ``csrc/``) and the fused train
step (``optim``). Entry points run on the card unless the caller passes
``device="cpu"``; the CPU path uses each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
