"""Memory-efficient fused linear + cross-entropy (counterpart of
torchft_tpu/ops/cross_entropy.py).

The (n, vocab) logits are never materialized: the forward walks vocab
slabs with an online logsumexp and saves one f32 lse per row; the backward
recomputes each slab's logits from (x, w), forms ``softmax - onehot`` in
the slab, and accumulates dx and the dw slab in place. The slab products
are plain f32 matrix products (the JAX package leaves them to XLA; it has
no kernel here), so they stay ``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["chunked_cross_entropy"]

_NEG_INF = -1e30


def _slab_logits(x32, w, start, chunk, vocab_valid):
    """f32 logits of vocab columns [start, start + chunk); columns past
    ``vocab_valid`` (the zero-padded tail slab) are masked to -1e30."""
    logits = x32 @ w[:, start:start + chunk].float()
    cols = start + torch.arange(chunk, device=logits.device)
    return logits.masked_fill(cols >= vocab_valid, _NEG_INF)


def _in_slab(targets1, start, chunk):
    local = targets1 - start
    return local.clamp(0, chunk - 1), (local >= 0) & (local < chunk)


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, targets1, chunk, vocab_valid):
        n = x2.shape[0]
        x32 = x2.float()
        m = torch.full((n,), float("-inf"), device=x2.device)
        s = torch.zeros(n, device=x2.device)
        tl = torch.zeros(n, device=x2.device)
        for start in range(0, w.shape[1], chunk):
            logits = _slab_logits(x32, w, start, chunk, vocab_valid)
            new_m = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[:, None]).sum(dim=1)
            m = new_m
            local, in_slab = _in_slab(targets1, start, chunk)
            picked = logits.gather(1, local[:, None])[:, 0]
            tl = torch.where(in_slab, picked, tl)
        lse = m + torch.log(s)
        ctx.save_for_backward(x2, w, targets1, lse)
        ctx.chunk, ctx.vocab_valid = chunk, vocab_valid
        return (lse - tl).mean()

    @staticmethod
    def backward(ctx, g):
        x2, w, targets1, lse = ctx.saved_tensors
        chunk, vocab_valid = ctx.chunk, ctx.vocab_valid
        n = x2.shape[0]
        scale = g / n  # d(mean)/d(per-row loss)
        x32 = x2.float()
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=x2.device)
        for start in range(0, w.shape[1], chunk):
            logits = _slab_logits(x32, w, start, chunk, vocab_valid)
            dlogits = torch.exp(logits - lse[:, None])  # softmax slab
            local, in_slab = _in_slab(targets1, start, chunk)
            dlogits.scatter_add_(1, local[:, None], -in_slab.float()[:, None])
            dlogits *= scale
            dx += dlogits @ w[:, start:start + chunk].float().T
            dw[:, start:start + chunk] = x32.T @ dlogits
        return dx.to(x2.dtype), dw.to(w.dtype), None, None, None


def chunked_cross_entropy(
    x: torch.Tensor,
    w: torch.Tensor,
    targets: torch.Tensor,
    vocab_chunk: Optional[int] = 4096,
) -> torch.Tensor:
    """Mean token cross-entropy of ``softmax(x @ w)`` against ``targets``
    without materializing the logits.

    Args:
        x: final hidden states ``(..., d)``; products run in f32.
        w: LM-head weight as ``(d, vocab)`` (for a torch ``Linear`` pass
           ``weight.T``; for tied embeddings ``embedding.weight.T``).
        targets: int targets of shape ``x.shape[:-1]``, clamped to
           ``[0, vocab)`` so the chunked and dense paths agree on invalid
           input.
        vocab_chunk: vocab slab width. A vocab that is not a multiple is
           zero-padded to one and the padded columns are masked to -1e30.
           ``None`` (or a chunk covering the vocab) computes densely.

    The f32 slab products must stay f32, so this sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
    before it runs.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    d = x.shape[-1]
    vocab = w.shape[1]
    x2 = x.reshape(-1, d)
    targets1 = targets.reshape(-1).long().clamp(0, vocab - 1)
    if vocab_chunk is None or vocab_chunk >= vocab:
        logp = torch.log_softmax(x2.float() @ w.float(), dim=-1)
        return -logp.gather(1, targets1[:, None]).mean()
    pad = (-vocab) % vocab_chunk
    if pad:
        w = F.pad(w, (0, pad))
    return _ChunkedCE.apply(x2, w, targets1, vocab_chunk, vocab)
