"""The port's fused linear + cross-entropy against the JAX package's.

Same numpy inputs into both; both compute in f32 with products of the
same shapes, so value and gradients agree to f32 summation order: atol
1e-5 on the loss and 1e-5 on the gradients (each gradient entry is a sum
over at most one vocab slab or one batch of rows, scaled by 1/n).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.ops.cross_entropy import chunked_cross_entropy as j_ce
from torchft_tpu_torch.ops.cross_entropy import chunked_cross_entropy as t_ce

# The shapes here are tiny: torch's intra-op threads only contend with the
# other test workers for the cores (one step of the tiny Llama runs ~17x
# slower on 8 threads than on 1), so every op runs on the calling thread.
torch.set_num_threads(1)

ATOL = 1e-5


def _inputs(vocab, out_of_range, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    w = (rng.standard_normal((32, vocab)) * 0.2).astype(np.float32)
    targets = rng.integers(0, vocab, (2, 24)).astype(np.int32)
    if out_of_range:
        targets[0, :3] = [-3, vocab, vocab + 40]
    return x, w, targets


@pytest.mark.parametrize(
    "vocab,chunk,out_of_range",
    [
        (300, 128, False),   # tail slab zero-padded and masked
        (300, 128, True),    # targets clamped to [0, vocab)
        (256, 64, False),    # vocab a multiple of the slab
        (300, None, True),   # dense path
    ],
)
def test_chunked_ce_value_and_grads_match_jax(vocab, chunk, out_of_range):
    x, w, targets = _inputs(vocab, out_of_range)
    j_loss, (j_dx, j_dw) = jax.value_and_grad(
        lambda x_, w_: j_ce(x_, w_, jnp.asarray(targets), chunk), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    t_loss = t_ce(tx, tw, torch.from_numpy(targets), chunk)
    t_loss.backward()

    np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), atol=ATOL, rtol=0)
    assert tw.grad.shape == (32, vocab)


def test_chunked_matches_dense_in_the_port():
    x, w, targets = _inputs(300, True, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(targets))
    np.testing.assert_allclose(
        t_ce(*args, 128).item(), t_ce(*args, None).item(), atol=ATOL, rtol=0
    )
