"""The port's Llama train step against the JAX package's, end to end.

A tiny config (``CONFIGS["tiny"]``, f32) is initialised by flax from
``PRNGKey(0)``, its weights cross through ``llama_state_dict_from_jax``,
and both packages take the same numpy tokens. JAX runs its flash path as
its own CPU tests do (Pallas forward in interpret mode); the port runs the
plain versions of its kernels. Both compute in f32, so loss and gradients
differ only in summation order: atol 1e-5 on the loss, 1e-4 on every
gradient and updated parameter.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.models import llama as jl
from torchft_tpu.optim import make_jit_fused_step
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.models.convert import llama_state_dict_from_jax
from torchft_tpu_torch.optim import make_fused_step, sgd

# The shapes here are tiny: torch's intra-op threads only contend with the
# other test workers for the cores (one step of the tiny Llama runs ~17x
# slower on 8 threads than on 1), so every op runs on the calling thread.
torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _configs(**fields):
    fields.setdefault("loss_vocab_chunk", 200)  # 512 is not a multiple
    return replace(jl.CONFIGS["tiny"], **fields), replace(tl.CONFIGS["tiny"], **fields)


def _tokens(seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(0, 512, (b, s + 1)).astype(np.int32)


def _both_models(**fields):
    jcfg, tcfg = _configs(**fields)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), _tokens()[:, :-1])
    tmodel = tl.Llama(tcfg, device="cpu")
    state = llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    tmodel.load_state_dict(state, strict=True)
    return jmodel, params, tmodel, tcfg


def _jax_loss(jmodel):
    return lambda p, t: jmodel.apply(p, t[:, :-1], targets=t[:, 1:])


def _torch_loss(model, t):
    return model(t[:, :-1], targets=t[:, 1:])


@pytest.mark.parametrize(
    "attention_impl,scan_layers,tie_embeddings",
    [
        ("flash", False, False),
        ("flash", True, False),   # stacked layers/block/... param layout
        ("flash", False, True),   # tied head
        ("dense", True, False),
    ],
)
def test_loss_and_every_gradient_match_jax(attention_impl, scan_layers, tie_embeddings):
    jmodel, params, tmodel, tcfg = _both_models(
        attention_impl=attention_impl, scan_layers=scan_layers,
        tie_embeddings=tie_embeddings,
    )
    tokens = _tokens(seed=1)
    j_loss, j_grads = jax.value_and_grad(_jax_loss(jmodel))(params, tokens)
    t_loss = _torch_loss(tmodel, torch.from_numpy(tokens))
    t_loss.backward()

    np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=LOSS_ATOL, rtol=0)
    j_named = llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), tcfg)
    t_named = dict(tmodel.named_parameters())
    assert set(j_named) == set(t_named)
    for name, grad in j_named.items():
        np.testing.assert_allclose(
            t_named[name].grad.numpy(), grad.numpy(), atol=GRAD_ATOL, rtol=0,
            err_msg=name,
        )


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_fused_step_with_sgd_momentum_matches_jax(num_microbatches):
    jmodel, params, tmodel, tcfg = _both_models(attention_impl="flash")
    j_step = make_jit_fused_step(
        optax.sgd(0.01, momentum=0.9), _jax_loss(jmodel), num_microbatches
    )
    t_step = make_fused_step(
        tmodel, sgd(0.01, momentum=0.9)(tmodel.parameters()), _torch_loss,
        num_microbatches,
    )
    opt_state = optax.sgd(0.01, momentum=0.9).init(params)
    for seed in (2, 3):  # the second step runs on the momentum buffer
        tokens = _tokens(seed=seed)
        j_loss, params, opt_state = j_step(params, opt_state, tokens)
        t_loss = t_step(torch.from_numpy(tokens))
        np.testing.assert_allclose(t_loss.item(), float(j_loss), atol=LOSS_ATOL, rtol=0)

    j_named = llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    for name, value in tmodel.state_dict().items():
        np.testing.assert_allclose(
            value.numpy(), j_named[name].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name
        )


def test_fused_step_sums_bf16_microbatch_gradients_in_f32():
    # Per-chunk gradients 1, 2^-9, 2^-9, 2^-9 of a bf16 weight: summed in
    # bf16 each 2^-9 (a quarter ulp of 1) rounds away and the mean is 0.25;
    # summed in f32, as make_microbatch_grad does, the mean 0.2515 rounds
    # to 0.251953125. Both packages must land on the f32 answer exactly.
    x = np.full((4, 8), 2.0**-9, np.float32)
    x[0] = 1.0

    def j_loss(params, xb):
        return (params["w"].astype(np.float32) * xb).sum()

    j_step = make_jit_fused_step(optax.sgd(1.0), j_loss, 4)
    params = {"w": jax.numpy.zeros(8, jax.numpy.bfloat16)}
    _, params, _ = j_step(params, optax.sgd(1.0).init(params), x)

    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(8, dtype=torch.bfloat16))
    t_step = make_fused_step(
        model, sgd(1.0)(model.parameters()),
        lambda m, xb: (m.w.float() * xb).sum(), num_microbatches=4,
    )
    t_step(torch.from_numpy(x))

    want = np.full(8, -0.251953125, np.float32)
    np.testing.assert_array_equal(np.asarray(params["w"], np.float32), want)
    np.testing.assert_array_equal(model.w.detach().float().numpy(), want)


@pytest.mark.parametrize(
    "momentum,nesterov", [(None, False), (0.9, False), (0.9, True)]
)
def test_sgd_matches_optax_step_for_step(momentum, nesterov):
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(4)]

    tx = optax.sgd(0.05, momentum=momentum, nesterov=nesterov)
    jp, state = p0, tx.init(p0)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = sgd(0.05, momentum=momentum, nesterov=nesterov)([param])
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def test_logits_match_jax_without_targets():
    jmodel, params, tmodel, _ = _both_models(attention_impl="flash")
    tokens = _tokens(seed=5)[:, :-1]
    j_logits = jmodel.apply(params, tokens)
    t_logits = tmodel(torch.from_numpy(tokens))
    assert t_logits.dtype == torch.float32 and t_logits.shape == (2, 64, 512)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), atol=1e-4, rtol=0)


def test_full_remat_gives_the_same_gradients():
    _, _, tmodel, tcfg = _both_models(attention_impl="flash")
    remat = tl.Llama(replace(tcfg, remat="full"), device="cpu")
    remat.load_state_dict(tmodel.state_dict())
    tokens = torch.from_numpy(_tokens(seed=6))
    _torch_loss(tmodel, tokens).backward()
    _torch_loss(remat, tokens).backward()
    for (name, a), b in zip(tmodel.named_parameters(), remat.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0, msg=name)
