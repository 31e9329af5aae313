"""Llama-family transformer as ``nn.Module``s (counterpart of
torchft_tpu/models/llama.py).

RMSNorm with f32 accumulation and an f32 scale, half-split rotary
embeddings, GQA attention, SwiGLU MLP, tied or untied output head.
Parameters live in ``config.dtype`` except the norm scales, as flax's
``param_dtype=cfg.dtype`` gives. Attention dispatches to the flash
kernels (ops/flash_attention.py) or the dense plain version; with
``targets`` the model returns the mean token cross-entropy through the
fused linear+CE (ops/cross_entropy.py), never forming the logits.

Not in this slice: ring and blockwise attention, ``remat="dots"`` and the
sharding plan, which wait for the mesh. ``scan_layers`` has no meaning
for an eager layer loop; it only tells models/convert.py which parameter
layout the JAX tree has.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.ops.cross_entropy import chunked_cross_entropy
from torchft_tpu_torch.ops.flash_attention import flash_attention
from torchft_tpu_torch.utils.platform import DeviceLike, resolve_device

__all__ = [
    "LlamaConfig",
    "Llama",
    "CONFIGS",
    "large_bench_config",
    "apply_rope",
    "causal_attention",
    "RMSNorm",
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    # "auto": the flash kernels for seq >= blockwise_min_seq on a CUDA
    # device, else dense. "dense", "flash"; "blockwise" and "ring" are
    # accepted for config parity and raise NotImplementedError on use.
    attention_impl: str = "auto"
    sp_axis: str = "sp"
    attention_block_size: int = 512
    attention_block_k: Optional[int] = 1024
    flash_batch_axes: Tuple[str, ...] = ("dp", "fsdp")
    flash_tp_axis: Optional[str] = "tp"
    ring_use_flash: bool = False
    blockwise_min_seq: int = 2048
    # "none", "full" (torch.utils.checkpoint per block); "dots" raises.
    remat: str = "none"
    # Vocab slab width of the fused linear+CE; None = dense CE.
    loss_vocab_chunk: Optional[int] = None
    scan_layers: bool = False

    def __post_init__(self) -> None:
        valid = ("auto", "dense", "blockwise", "flash", "ring")
        if self.attention_impl not in valid:
            raise ValueError(
                f"attention_impl={self.attention_impl!r} is not one of {valid}"
            )
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(
                f"remat={self.remat!r} is not one of ('none', 'full', 'dots')"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_hidden=128, max_seq_len=256, dtype=torch.float32,
    ),
    "small": LlamaConfig(
        vocab_size=8192, dim=512, n_layers=6, n_heads=8, n_kv_heads=4,
        ffn_hidden=1536, max_seq_len=2048,
    ),
    "1b": LlamaConfig(
        vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        ffn_hidden=8192, max_seq_len=8192,
    ),
    "8b": LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_hidden=14336, max_seq_len=8192,
    ),
    "70b": LlamaConfig(
        vocab_size=128256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        ffn_hidden=28672, max_seq_len=8192,
    ),
}


def large_bench_config(**overrides) -> LlamaConfig:
    """The ~445M-parameter flagship config of the JAX package's bench
    (vocab 32768, dim 1024, 24 layers, 8 heads of 128 over 4 KV heads,
    ffn 4096, seq 2048, bf16, flash attention, fused CE with 4096-wide
    slabs), field for field. ``overrides`` are dataclasses.replace fields;
    the port runs it with ``remat="none"``."""
    base = LlamaConfig(
        vocab_size=32768, dim=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        ffn_hidden=4096, max_seq_len=2048, dtype=torch.bfloat16,
        attention_impl="flash", scan_layers=True, loss_vocab_chunk=4096,
        remat="dots",
    )
    return replace(base, **overrides) if overrides else base


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (b, s, heads, head_dim); positions:
    (b, s). Computed in f32, returned in x's dtype."""
    hd = x.shape[-1]
    freqs = 1.0 / (
        theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    )
    angles = positions[..., None].float() * freqs  # (b, s, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """Dense grouped-query causal attention: products in the input dtype,
    f32 softmax, probabilities cast to v's dtype before P.V. Shapes: q
    (b, s, h, d); k, v (b, s, kv, d)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, h, d)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


def _linear(cfg: LlamaConfig, n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=cfg.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.config = cfg
        hd = cfg.head_dim
        self.wq = _linear(cfg, cfg.dim, cfg.n_heads * hd, device)
        self.wk = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wv = _linear(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wo = _linear(cfg, cfg.n_heads * hd, cfg.dim, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        q = self.wq(x).view(b, s, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        scale = cfg.head_dim**-0.5
        if cfg.attention_impl == "flash" or (
            cfg.attention_impl == "auto" and s >= cfg.blockwise_min_seq and q.is_cuda
        ):
            out = flash_attention(
                q, k, v, scale=scale,
                block_q=cfg.attention_block_size,
                block_k=cfg.attention_block_k or cfg.attention_block_size,
            )
        else:
            out = causal_attention(q, k, v, scale)
        return self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.w_gate = _linear(cfg, cfg.dim, cfg.ffn_hidden, device)
        self.w_up = _linear(cfg, cfg.dim, cfg.ffn_hidden, device)
        self.w_down = _linear(cfg, cfg.ffn_hidden, cfg.dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """``model(tokens)`` returns f32 logits; ``model(tokens,
    targets=targets)`` returns the mean token cross-entropy (through the
    fused linear+CE when ``config.loss_vocab_chunk`` is set).

    ``device`` defaults to the CUDA card and raises where there is none;
    pass ``device="cpu"`` for the CPU. Weights are drawn from
    ``generator`` (default: a generator on ``device`` seeded with 0) with
    the JAX package's initializers: truncated-normal fan-in for the
    projections, normal(1/sqrt(dim)) for the embedding, ones for norms.
    """

    def __init__(
        self,
        config: LlamaConfig,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if config.attention_impl in ("ring", "blockwise"):
            raise NotImplementedError(
                f"attention_impl={config.attention_impl!r} is not ported yet"
            )
        if config.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported yet")
        device = resolve_device(device)
        self.config = config
        self.tok_embed = nn.Embedding(
            config.vocab_size, config.dim, device=device, dtype=config.dtype
        )
        self.layers = nn.ModuleList(Block(config, device) for _ in range(config.n_layers))
        self.final_norm = RMSNorm(config.dim, config.norm_eps, config.dtype, device)
        self.lm_head = (
            None if config.tie_embeddings
            else _linear(config, config.dim, config.vocab_size, device)
        )
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, nn.Linear):
                # flax lecun_normal: truncated at 2 std, std corrected for it.
                std = 1.0 / math.sqrt(module.in_features) / 0.87962566103423978
                w = torch.empty(module.weight.shape, device=module.weight.device)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                module.weight.copy_(w)
            elif isinstance(module, nn.Embedding):
                w = torch.empty(module.weight.shape, device=module.weight.device)
                w.normal_(0.0, self.config.dim**-0.5, generator=generator)
                module.weight.copy_(w)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)

    def head_weight(self) -> torch.Tensor:
        """The output projection as (dim, vocab)."""
        head = self.tok_embed if self.lm_head is None else self.lm_head
        return head.weight.T

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        targets: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.config
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self.tok_embed(tokens)
        for block in self.layers:
            if cfg.remat == "full" and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.final_norm(x)
        if targets is not None:
            return chunked_cross_entropy(x, self.head_weight(), targets, cfg.loss_vocab_chunk)
        return (x @ self.head_weight()).float()
