"""The port's flash attention against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages. On the
CPU the port runs each kernel's plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode (forward and the dq/dk/dv backward,
``use_pallas_bwd=True``). Both compute in f32 here, so they differ only in
summation order: outputs are held to atol 2e-5 (the JAX package's own
flash-vs-dense bound) and gradients, which sum over a whole sequence of
such terms, to atol 1e-4.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.ops import flash_attention as jfa
from torchft_tpu_torch.ops import flash_attention as tfa

# The shapes here are tiny: torch's intra-op threads only contend with the
# other test workers for the cores (one step of the tiny Llama runs ~17x
# slower on 8 threads than on 1), so every op runs on the calling thread.
torch.set_num_threads(1)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, atol, what=""):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=what
    )


@pytest.mark.parametrize("s", [256, 200])  # 200: ragged against every tile
def test_flash_attention_forward_and_grads_match_jax(s):
    import jax

    b, h, kv, d = 2, 4, 2, 64
    rng = np.random.default_rng(s)
    q, k, v, w = (_randn(rng, b, s, n, d) for n in (h, kv, kv, h))

    def jax_loss(q, k, v):
        out = jfa.flash_attention(
            q, k, v, block_q=64, block_k=128, interpret=True, use_pallas_bwd=True
        )
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    t_out = tfa.flash_attention(tq, tk, tv)
    (t_out * torch.from_numpy(w)).sum().backward()

    _close(t_out, j_out, OUT_ATOL, "out")
    for name, t, j in zip("qkv", (tq, tk, tv), j_grads):
        _close(t.grad, j, GRAD_ATOL, f"d{name}")


def _partial_inputs(seed=3):
    """Queries at permuted positions (sq != sk, ragged) against two KV
    halves, and a third KV block that lies wholly after every query."""
    b, sq, sk, h, kv, d = 2, 200, 256, 4, 2, 64
    rng = np.random.default_rng(seed)
    q = _randn(rng, b, sq, h, d)
    k, v = _randn(rng, b, sk, kv, d), _randn(rng, b, sk, kv, d)
    qp = np.broadcast_to(rng.permutation(sk)[:sq].astype(np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    return q, k, v, qp, kp


def _both_partial(q, k, v, qp, kp):
    j = jfa.flash_attention_partial(
        *(jnp.asarray(x) for x in (q, k, v, qp, kp)),
        block_q=64, block_k=128, interpret=True,
    )
    t = tfa.flash_attention_partial(*(torch.from_numpy(x) for x in (q, k, v, qp, kp)))
    return j, t


def test_partial_with_permuted_positions_and_merge_match_jax():
    q, k, v, qp, kp = _partial_inputs()
    half = k.shape[1] // 2
    (j1, jl1), (t1, tl1) = _both_partial(q, k[:, :half], v[:, :half], qp, kp[:, :half])
    (j2, jl2), (t2, tl2) = _both_partial(q, k[:, half:], v[:, half:], qp, kp[:, half:])
    for t, j, what in ((t1, j1, "out1"), (tl1, jl1, "lse1"), (t2, j2, "out2"), (tl2, jl2, "lse2")):
        _close(t, j, OUT_ATOL, what)

    j_m, j_lse = jfa.merge_attention_partials(j1, jl1, j2, jl2)
    t_m, t_lse = tfa.merge_attention_partials(t1, tl1, t2, tl2)
    _close(t_m, j_m, OUT_ATOL, "merged out")
    _close(t_lse, j_lse, OUT_ATOL, "merged lse")
    # The merge of the two halves is attention over the whole KV set.
    t_full, t_full_lse = tfa.flash_attention_partial(
        *(torch.from_numpy(x) for x in (q, k, v, qp, kp))
    )
    _close(t_m, t_full.numpy(), OUT_ATOL, "merged vs whole")
    _close(t_lse, t_full_lse.numpy(), OUT_ATOL, "merged lse vs whole")


def test_fully_masked_hop_gives_zero_out_and_sentinel_lse():
    q, k, v, qp, kp = _partial_inputs(seed=4)
    (j, jl), (t, tl) = _both_partial(q, k, v, qp, kp + 1000)
    assert torch.equal(t, torch.zeros_like(t))
    assert torch.equal(tl, torch.full_like(tl, -1e30))
    _close(t, j, 0.0, "masked out")
    _close(tl, jl, 0.0, "masked lse")
    # Merging an empty partial leaves the other one as it was.
    (_, _), (t1, tl1) = _both_partial(q, k, v, qp, kp)
    t_m, t_lse = tfa.merge_attention_partials(t1, tl1, t, tl)
    _close(t_m, t1.numpy(), 1e-6, "merge with empty")
    _close(t_lse, tl1.numpy(), 1e-6, "merge lse with empty")


def test_partial_bwd_with_global_lse_matches_jax():
    q, k, v, qp, kp = _partial_inputs(seed=5)
    rng = np.random.default_rng(6)
    d_out = _randn(rng, *q.shape)
    half = k.shape[1] // 2
    # The global (whole-KV) out and lse, as a ring backward would hold them.
    out, lse = (
        x.numpy() for x in tfa.flash_attention_partial(
            *(torch.from_numpy(x) for x in (q, k, v, qp, kp))
        )
    )
    args = (q, k[:, :half], v[:, :half], d_out, out, lse, qp, kp[:, :half])
    j = jfa.flash_attention_partial_bwd(
        *(jnp.asarray(x) for x in args), q.shape[-1] ** -0.5, 64, 128, True
    )
    t = tfa.flash_attention_partial_bwd(
        *(torch.from_numpy(x) for x in args), q.shape[-1] ** -0.5
    )
    for name, tg, jg in zip(("dq", "dk", "dv"), t, j):
        assert tg.dtype == torch.float32
        _close(tg, jg, GRAD_ATOL, name)


def test_reference_versions_agree_with_dense_attention():
    """The plain versions the CPU path runs agree with the model's dense
    attention, independent of the JAX package (f32, atol 2e-5)."""
    from torchft_tpu_torch.models.llama import causal_attention

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_randn(rng, 1, 96, n, 64)) for n in (4, 2, 2))
    pos = torch.arange(96, dtype=torch.int32).expand(1, 96)
    out, _ = tfa.flash_fwd_reference(q, k, v, pos, pos, 0.125)
    _close(out, causal_attention(q, k, v, 0.125).numpy(), OUT_ATOL, "out")


def test_kernel_path_refuses_tensors_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not computed with the plain version."""
    q = torch.empty(1, 64, 2, 64, device="meta")
    k = torch.empty(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tfa.flash_attention_partial(
            q, k, k, torch.zeros(1, 64, dtype=torch.int32, device="meta"),
            torch.zeros(1, 64, dtype=torch.int32, device="meta"),
        )


def test_cpu_path_launches_no_kernel():
    tfa.reset_launches()
    q = torch.zeros(1, 16, 2, 16, requires_grad=True)
    k = torch.zeros(1, 16, 1, 16, requires_grad=True)
    tfa.flash_attention(q, k, k).sum().backward()
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


# bf16 backward: the plain versions the card holds the kernels to, against
# the JAX package's Pallas backward (interpret mode) on the same bf16
# inputs, f32 gradients. Both round p before dV and ds before dK and dQ to
# bf16, from f32 sums taken in other orders, so where a sum lands next to
# a rounding boundary one ds or p flips by a bf16 ulp (2^-8 of it): the
# gradients agree to 0.5% of their RMS element by element and to 1e-4 of
# their norm.
BF16_GRAD_RMS_FRACTION = 5e-3
BF16_GRAD_NORM = 1e-4


@pytest.mark.parametrize("s,h,kv,d", [(200, 4, 1, 64), (200, 2, 2, 128), (136, 4, 2, 64)])
def test_bf16_backward_reference_matches_jax_rounding_points(s, h, kv, d):
    b = 2
    rng = np.random.default_rng(1000 + s + h + d)
    q, d_out = _randn(rng, b, s, h, d), _randn(rng, b, s, h, d)
    k, v = _randn(rng, b, s, kv, d), _randn(rng, b, s, kv, d)
    qp = np.stack([rng.permutation(s) for _ in range(b)]).astype(np.int32)
    kp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    scale = d**-0.5
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, d_out))
    tqp, tkp = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, tqp, tkp, scale)
    delta = (tdo.float() * out.float()).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta, tqp, tkp, scale, torch.float32)
    port = (tfa.flash_bwd_dq_reference(*args), *tfa.flash_bwd_dkv_reference(*args))

    bf16 = lambda x: jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    ref = jfa.flash_attention_partial_bwd(
        bf16(tq), bf16(tk), bf16(tv), bf16(tdo), bf16(out), jnp.asarray(lse.numpy()),
        jnp.asarray(qp), jnp.asarray(kp), scale, 64, 128, True, out_dtype=jnp.float32,
    )
    for name, got, want in zip(("dq", "dk", "dv"), port, ref):
        want = np.asarray(want, dtype=np.float32)
        got = got.numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        rms = np.sqrt(np.mean(want**2))
        err = np.abs(got - want)
        assert err.max() <= BF16_GRAD_RMS_FRACTION * rms, (name, err.max() / rms)
        assert np.linalg.norm(got - want) <= BF16_GRAD_NORM * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))
