"""PyTorch and CUDA port of torchft_tpu, beside the JAX package it is held
against.

Slice 1 is the device half of the train step: the Llama model
(``models.llama``), its fused linear+cross-entropy loss
(``ops.cross_entropy``), flash attention with hand-written Hopper kernels
(``ops.flash_attention``) and the fused train step (``optim``). Slice 2 is
FT-DDP across replica groups: the native coordination plane built without
protobuf's C++ side (``_native``, ``coordination``), process groups and
quantized collectives (``parallel``), the blockwise fp8/int8 codec with
hand-written kernels (``ops.quantization``), a ``manager.Manager`` for runs
where no group dies, ``ddp`` and ``optim.Optimizer``. CUDA sources are in
``csrc/``. Entry points run on the card unless the caller passes
``device="cpu"``; the CPU path uses each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
