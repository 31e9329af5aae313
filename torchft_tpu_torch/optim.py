"""The fused local train step (counterpart of ``make_jit_fused_step`` and
``make_microbatch_grad`` in torchft_tpu/optim.py).

PyTorch runs eagerly, so the "one program" of the JAX step becomes one
Python call: zero the grads, forward, backward, optimizer step. The
fault-tolerant ``Optimizer`` wrapper and the ``Manager`` it drives come
with the coordination plane.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Iterable, Optional

import torch

__all__ = ["make_fused_step", "sgd"]


def sgd(
    lr: float, momentum: Optional[float] = None, nesterov: bool = False
) -> Callable[[Iterable[torch.nn.Parameter]], torch.optim.SGD]:
    """``optax.sgd(lr, momentum, nesterov)`` as a factory of
    ``torch.optim.SGD`` over the given parameters. With ``dampening=0`` the
    two agree step for step: optax's trace is ``g + momentum * trace`` from
    a zero start, torch's buffer is ``g`` on the first step and
    ``momentum * buf + g`` after, and both subtract ``lr`` times it."""
    return partial(
        torch.optim.SGD, lr=lr, momentum=momentum or 0.0, dampening=0.0,
        nesterov=nesterov,
    )


def make_fused_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[..., torch.Tensor],
    num_microbatches: int = 1,
) -> Callable[..., torch.Tensor]:
    """``step(*batch) -> loss``: one whole local train step.

    ``loss_fn(model, *batch) -> scalar``. Each call zeroes the grads, runs
    forward and backward and then ``optimizer.step()``, and returns the
    loss (detached, on the model's device, not synchronized).
    ``num_microbatches > 1`` splits every batch tensor's leading axis into
    equal chunks and averages loss and gradients over them, with one
    chunk's activations live at a time. As in the JAX version, the chunks'
    gradients are summed in f32 and cast to the parameters' dtype once,
    after the mean, so a bf16 model loses no gradient mass across chunks."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")

    def split(x: Any):
        if getattr(x, "ndim", 0) == 0:
            raise ValueError(
                "make_fused_step: every batch tensor needs the batch axis at "
                "dim 0 (close over non-batched arguments instead)"
            )
        if x.shape[0] % num_microbatches:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"num_microbatches={num_microbatches}"
            )
        return x.chunk(num_microbatches, dim=0)

    def step(*batch: Any) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if num_microbatches == 1:
            loss = loss_fn(model, *batch)
            loss.backward()
            total = loss.detach()
        else:
            total, sums = 0.0, {}
            for micro in zip(*(split(x) for x in batch)):
                loss = loss_fn(model, *micro)
                loss.backward()
                total = total + loss.detach().float()
                for param in model.parameters():
                    if param.grad is not None:
                        if param in sums:
                            sums[param].add_(param.grad)
                        else:
                            sums[param] = param.grad.float()
                        param.grad = None
            inv = 1.0 / num_microbatches
            for param, grad_sum in sums.items():
                param.grad = grad_sum.mul_(inv).to(param.dtype)
            total = total * inv
        optimizer.step()
        return total

    return step
