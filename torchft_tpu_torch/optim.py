"""Train steps: the fused local step (counterpart of ``make_jit_fused_step``
and ``make_microbatch_grad`` in torchft_tpu/optim.py) and the
fault-tolerant :class:`Optimizer` with its ``make_step_fn``.

PyTorch runs eagerly, so the "one program" of the JAX step becomes one
Python call: zero the grads, forward, backward, optimizer step. The
:class:`Optimizer` puts that step under the Manager's commit barrier: the
torch optimizer steps only when the whole quorum commits.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["make_fused_step", "sgd", "Optimizer"]


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


def _backward(
    model: torch.nn.Module,
    loss_fn: Callable[..., torch.Tensor],
    batch: Sequence[Any],
    num_microbatches: int,
) -> torch.Tensor:
    """Zeroes the grads, runs forward and backward, and leaves the batch's
    gradients in ``.grad``; returns the loss (detached, not synchronized).
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

    for param in model.parameters():
        param.grad = None
    if num_microbatches == 1:
        loss = loss_fn(model, *batch)
        loss.backward()
        return loss.detach()
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
    return total * inv


def make_fused_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[..., torch.Tensor],
    num_microbatches: int = 1,
) -> Callable[..., torch.Tensor]:
    """``step(*batch) -> loss``: one whole local train step.

    ``loss_fn(model, *batch) -> scalar``. Each call zeroes the grads, runs
    forward and backward and then ``optimizer.step()``, and returns the
    loss (detached, on the model's device, not synchronized). Microbatches
    as in :func:`_backward`."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {num_microbatches}")

    def step(*batch: Any) -> torch.Tensor:
        loss = _backward(model, loss_fn, batch, num_microbatches)
        optimizer.step()
        return loss

    return step


def _sync_device(x: torch.Tensor) -> None:
    """Waits for the device work behind ``x`` (nothing to wait for on the
    CPU): a replica whose math never finished must not vote to commit."""
    if x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()


class Optimizer:
    """Owns a torch optimizer over a model; steps only on quorum-wide commit
    (counterpart of ``Optimizer`` in torchft_tpu/optim.py).

        opt = Optimizer(manager, sgd(0.01, momentum=0.9)(model.parameters()), model)
        step_fn = opt.make_step_fn(loss_fn, should_quantize=True)
        loss, committed = step_fn(batch)

    The model's and the optimizer's state are registered with the manager
    under ``register_key``, where a heal (a later slice) will load them.
    """

    def __init__(
        self,
        manager: Any,
        optimizer: torch.optim.Optimizer,
        model: torch.nn.Module,
        register_key: str = "optimizer",
    ) -> None:
        self.manager = manager
        self.optimizer = optimizer
        self.model = model
        manager.register_state_dict_fn(register_key, self._load_state_dict, self._state_dict)

    def _state_dict(self) -> Any:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def _load_state_dict(self, state: Any) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def begin_step(self, timeout: Optional[float] = None, shrink_only: bool = False) -> None:
        """Starts the (async) quorum for this step; call before the forward
        pass so quorum latency overlaps compute."""
        self.manager.start_quorum(shrink_only=shrink_only, timeout=timeout)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """torch's step protocol: starts the quorum and clears the grads."""
        self.begin_step()
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(
        self, grads: Optional[Sequence[torch.Tensor]] = None, timeout: Optional[float] = None
    ) -> bool:
        """Commits the step; on success applies ``grads`` (one per parameter
        that has a ``.grad``, in ``model.parameters()`` order; default: the
        ``.grad`` tensors as they are) with the torch optimizer. Returns
        whether the step committed. The device work is waited for before the
        vote leaves, and the update runs only after the barrier agreed."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        if grads is not None:
            grads = list(grads)
            if len(grads) != len(params):
                raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
            for param, grad in zip(params, grads):
                param.grad = grad
        if params:
            _sync_device(params[-1].grad)
        if not self.manager.should_commit(timeout=timeout):
            return False
        self.optimizer.step()
        return True

    def make_step_fn(
        self,
        loss_fn: Callable[..., torch.Tensor],
        should_quantize: bool = False,
        on_quorum: Optional[Callable[[float], None]] = None,
        num_microbatches: int = 1,
    ) -> Callable[..., Tuple[torch.Tensor, bool]]:
        """Builds the FT-DDP step for the current quorum:
        ``step_fn(*batch) -> (loss, committed)``; ``loss_fn(model, *batch)``.

        With other replica groups participating, the step is the strict
        split ordering: forward and backward, the bucketed gradient sync
        (:func:`~torchft_tpu_torch.ddp.ft_allreduce_gradients`, fp8 buckets
        with ``should_quantize``), then :meth:`step` under the barrier.

        For a lone replica (sole participant and a wire group of one, see
        ``Manager.is_lone_replica``) the averaged gradient is the local one,
        so nothing leaves the device: the step is the fused local step
        (:func:`make_fused_step`'s forward and backward), its commit vote
        launched while the device finishes, and the optimizer steps when
        the barrier agrees. ``on_quorum(seconds)``, when given, receives
        each step's measured quorum wait."""

        def step_fn(*batch: Any) -> Tuple[torch.Tensor, bool]:
            self.begin_step()
            t0 = time.perf_counter()
            self.manager.wait_quorum()
            if on_quorum is not None:
                on_quorum(time.perf_counter() - t0)
            loss = _backward(self.model, loss_fn, batch, num_microbatches)
            if self.manager.errored() is None and self.manager.is_lone_replica():
                # The barrier RPC rides under the device wait.
                commit_future = self.manager.should_commit_async()
                try:
                    _sync_device(loss)
                finally:
                    committed = commit_future.result()
                if committed:
                    self.optimizer.step()
                return loss, committed
            from torchft_tpu_torch.ddp import ft_allreduce_gradients

            params = [p for p in self.model.parameters() if p.grad is not None]
            averaged = ft_allreduce_gradients(
                self.manager, [p.grad for p in params], should_quantize
            )
            return loss, self.step(averaged)

        return step_fn
