"""Two replica groups of FT-DDP with the fp8 bucket codec, in each package.

Each package runs its own lighthouse and two groups as threads: a 2-layer
Llama (f32, dim 256, so every parameter holds a multiple of 256 elements
and no codec block straddles two of them), the same weights in every
group (flax init from ``PRNGKey(0)``, converted for the port), different
batches per group, ``Manager(init_sync=False)`` over ``ProcessGroupNative``,
and 3 steps of ``Optimizer.make_step_fn(loss_fn, should_quantize=True)``
with SGD momentum 0.9 and a 0.25 MiB bucket cap, which gives several
buckets per step.

Within each package the groups end bitwise identical. Step and commit
accounting equal the reference's exactly. Losses and parameters agree
across the packages within a stated tolerance: the step-0 loss to f32
summation order; later ones differ because the JAX package's codec is
jitted, and XLA computes a block's scale as ``maxabs * (1/448)`` where the
port divides (one ulp of the scale, see test_torch_codec.py), which can
move a payload value on a rounding boundary by one fp8 step. An averaged
gradient passes two quantizations (each group's bucket, then the requantized
sum), so it may differ by up to two fp8 steps of its block, and an fp8 step
is at most 1/14 of the block's max (32 at 448). A parameter may then differ
by the learning rate times, over the steps, two fourteenths of the largest
averaged gradient of that step, weighted by how often momentum carries the
step into later updates (2.71, 1.9, 1), plus f32 rounding.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import Callable, Dict, List

import jax
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import coordination as jcoord
from torchft_tpu import manager as jmanager
from torchft_tpu import optim as joptim
from torchft_tpu.models import llama as jl
from torchft_tpu.parallel import native_pg as jpg
from torchft_tpu.parallel import store as jstore
from torchft_tpu_torch import coordination as tcoord
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import optim as toptim
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.models.convert import llama_state_dict_from_jax
from torchft_tpu_torch.parallel import native_pg as tpg
from torchft_tpu_torch.parallel import store as tstore

torch.set_num_threads(1)

STEPS = 3
LR = 0.05
JOIN_TIMEOUT = 120.0
FIELDS = dict(dim=256, ffn_hidden=512, loss_vocab_chunk=256, attention_impl="dense")
# Step-0 losses come from the same weights and tokens: f32 summation order.
LOSS0_ATOL = 1e-5
# Later losses see the parameter differences bounded below; the largest
# loss difference measured at these shapes is 3.8e-4.
LOSS_ATOL = 1e-3
MOMENTUM_WEIGHTS = (1 + 0.9 + 0.81, 1 + 0.9, 1)  # step i's gradient in later updates


def _tokens(group: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * group + step)
    return rng.integers(0, 512, (2, 33)).astype(np.int32)


def _run_groups(fns: List[Callable[[], object]]) -> List[object]:
    results: Dict[int, object] = {}
    errors: Dict[int, BaseException] = {}

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive(), "a replica group did not finish in time"
    if errors:
        raise next(iter(errors.values()))
    return [results[i] for i in range(len(fns))]


@pytest.fixture(scope="module")
def init_params():
    jcfg = replace(jl.CONFIGS["tiny"], **FIELDS)
    jmodel = jl.Llama(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), _tokens(0, 0)[:, :-1])
    return jmodel, params


def _jax_group(lighthouse, jmodel, params, group):
    def run():
        store = jstore.StoreServer()
        pg = jpg.ProcessGroupNative(timeout=30.0)
        manager = jmanager.Manager(
            pg=pg, min_replica_size=2,
            store=jstore.StoreClient(store.address()), store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=f"jax{group}",
            init_sync=False, timeout=30.0, quorum_timeout=30.0,
        )
        try:
            opt = joptim.Optimizer(manager, optax.sgd(LR, momentum=0.9), params)
            step = opt.make_step_fn(
                lambda p, t: jmodel.apply(p, t[:, :-1], targets=t[:, 1:]),
                should_quantize=True,
            )
            trace = []
            for i in range(STEPS):
                loss, committed = step(_tokens(group, i))
                trace.append((float(loss), bool(committed), manager.current_step(),
                              manager.batches_committed()))
            return trace, jax.tree_util.tree_map(np.asarray, opt.params)
        finally:
            manager.shutdown(wait=False)
            pg.shutdown()
            store.shutdown()
    return run


def _port_group(lighthouse, state, group):
    def run():
        store = tstore.StoreServer()
        pg = tpg.ProcessGroupNative(timeout=30.0)
        manager = tmanager.Manager(
            pg=pg, min_replica_size=2,
            store=tstore.StoreClient(store.address()), store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=f"port{group}",
            init_sync=False, timeout=30.0, quorum_timeout=30.0,
        )
        try:
            model = tl.Llama(replace(tl.CONFIGS["tiny"], **FIELDS), device="cpu")
            model.load_state_dict(state, strict=True)
            opt = toptim.Optimizer(manager, toptim.sgd(LR, momentum=0.9)(model.parameters()), model)
            step = opt.make_step_fn(
                lambda m, t: m(t[:, :-1], targets=t[:, 1:]), should_quantize=True
            )
            trace, grad_max = [], []
            for i in range(STEPS):
                loss, committed = step(torch.from_numpy(_tokens(group, i)))
                trace.append((loss.item(), committed, manager.current_step(),
                              manager.batches_committed()))
                # The averaged gradient this step applied, largest entry.
                grad_max.append({n: p.grad.abs().max().item() for n, p in model.named_parameters()})
            state_out = {k: v.detach().clone() for k, v in model.state_dict().items()}
            return trace, state_out, grad_max
        finally:
            manager.shutdown(wait=False)
            pg.shutdown()
            store.shutdown()
    return run


def test_two_groups_fp8_ddp_matches_the_jax_package(init_params, monkeypatch):
    monkeypatch.setenv("TPUFT_BUCKET_MB", "0.25")
    monkeypatch.setenv("TPUFT_WIRE_DTYPE", "fp8")
    jmodel, params = init_params
    tcfg = replace(tl.CONFIGS["tiny"], **FIELDS)
    state = llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)

    jlight = jcoord.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    try:
        jax_out = _run_groups([_jax_group(jlight, jmodel, params, g) for g in range(2)])
    finally:
        jlight.shutdown()
    tlight = tcoord.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    try:
        port_out = _run_groups([_port_group(tlight, state, g) for g in range(2)])
    finally:
        tlight.shutdown()

    # Within each package the groups are bitwise identical.
    jax_states = [llama_state_dict_from_jax(p, tcfg) for _, p in jax_out]
    for name in state:
        assert torch.equal(jax_states[0][name], jax_states[1][name]), name
        assert torch.equal(port_out[0][1][name], port_out[1][1][name]), name

    # Step and commit accounting: every step commits, 2 batches a step.
    for (jtrace, _), (ttrace, _, _) in zip(jax_out, port_out):
        assert [t[1:] for t in ttrace] == [t[1:] for t in jtrace]
        assert [t[1:] for t in ttrace] == [(True, i + 1, 2 * (i + 1)) for i in range(STEPS)]

    # Losses and parameters within the stated tolerance.
    for (jtrace, _), (ttrace, _, _) in zip(jax_out, port_out):
        np.testing.assert_allclose(ttrace[0][0], jtrace[0][0], atol=LOSS0_ATOL, rtol=0)
        np.testing.assert_allclose(
            [t[0] for t in ttrace], [t[0] for t in jtrace], atol=LOSS_ATOL, rtol=0
        )
    _, port_state, grad_max = port_out[0]
    for name, want in jax_states[0].items():
        tol = LR * sum(
            w * 2 * g[name] / 14 for w, g in zip(MOMENTUM_WEIGHTS, grad_max)
        ) + 1e-6
        err = (port_state[name] - want).abs().max().item()
        assert err <= tol, f"{name}: {err} > {tol}"


def _port_groups(n, init_sync, body, **manager_kwargs):
    """Runs ``body(manager, model, group)`` in ``n`` port groups as threads
    over a fresh lighthouse; returns the bodies' results."""
    manager_kwargs.setdefault("min_replica_size", n)
    lighthouse = tcoord.LighthouseServer(bind="[::]:0", min_replicas=n, join_timeout_ms=100)
    cfg = replace(tl.CONFIGS["tiny"], **FIELDS)

    def group(g):
        def run():
            store = tstore.StoreServer()
            pg = tpg.ProcessGroupNative(timeout=30.0)
            manager = tmanager.Manager(
                pg=pg,
                store=tstore.StoreClient(store.address()), store_addr=store.address(),
                lighthouse_addr=lighthouse.address(), replica_id=f"port{g}",
                init_sync=init_sync, timeout=30.0, quorum_timeout=30.0, **manager_kwargs,
            )
            try:
                model = tl.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
                return body(manager, model, g)
            finally:
                manager.shutdown(wait=False)
                pg.shutdown()
                store.shutdown()
        return run

    try:
        return _run_groups([group(g) for g in range(n)])
    finally:
        lighthouse.shutdown()


def _loss(model, tokens):
    return model(tokens[:, :-1], targets=tokens[:, 1:])


def test_lone_group_takes_the_fused_step():
    def body(manager, model, g):
        reference = tl.Llama(replace(tl.CONFIGS["tiny"], **FIELDS), device="cpu")
        reference.load_state_dict(model.state_dict())
        fused = toptim.make_fused_step(
            reference, toptim.sgd(LR, momentum=0.9)(reference.parameters()), _loss
        )
        opt = toptim.Optimizer(manager, toptim.sgd(LR, momentum=0.9)(model.parameters()), model)
        step = opt.make_step_fn(_loss, should_quantize=True)
        for i in range(2):
            tokens = torch.from_numpy(_tokens(g, i))
            loss, committed = step(tokens)
            assert committed and manager.is_lone_replica()
            assert loss.item() == fused(tokens).item()
        for a, b in zip(model.parameters(), reference.parameters()):
            assert torch.equal(a, b)
        return manager.current_step(), manager.batches_committed()

    assert _port_groups(1, False, body) == [(2, 2)]


def test_plain_wire_averages_gradients_exactly(monkeypatch):
    """The unquantized wire through DistributedDataParallel and
    Optimizer.step, the manual step protocol: the average is exact."""
    from torchft_tpu_torch.ddp import DistributedDataParallel

    monkeypatch.setenv("TPUFT_BUCKET_MB", "0.25")

    def body(manager, model, g):
        local = []
        for group in range(2):  # every group's local gradients, computed here
            copy = tl.Llama(replace(tl.CONFIGS["tiny"], **FIELDS), device="cpu")
            copy.load_state_dict(model.state_dict())
            _loss(copy, torch.from_numpy(_tokens(group, 0))).backward()
            local.append([p.grad for p in copy.parameters()])
        want = [(a + b) / 2 for a, b in zip(*local)]
        opt = toptim.Optimizer(manager, toptim.sgd(LR)(model.parameters()), model)
        ddp = DistributedDataParallel(manager, model)
        before = [p.detach().clone() for p in model.parameters()]
        opt.zero_grad()
        _loss(ddp, torch.from_numpy(_tokens(g, 0))).backward()
        ddp.sync_gradients(should_quantize=False)
        assert opt.step()
        for p, p0, grad in zip(model.parameters(), before, want):
            assert torch.equal(p.grad, grad)
            assert torch.equal(p.detach(), p0.add(grad, alpha=-LR))  # SGD's update
        return [p.detach() for p in model.parameters()]

    a, b = _port_groups(2, False, body)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_recovery_assignment_raises_not_implemented():
    """init_sync=True (the default) makes the quorum heal every non-primary
    group at step 0; healing is not in this slice."""

    def body(manager, model, g):
        manager.start_quorum()
        with pytest.raises(NotImplementedError, match="next slice"):
            manager.wait_quorum()
        return g

    assert _port_groups(2, True, body) == [0, 1]
    with pytest.raises(NotImplementedError, match="pipelined commit"):
        tmanager.Manager(None, 1, None, "", commit_pipeline_depth=1)


def test_too_few_replicas_do_not_commit_and_max_retries_escalates():
    """A quorum smaller than min_replica_size votes no: the optimizer does
    not step, and past max_retries the barrier raises (the supervisor's
    restart signal)."""

    def body(manager, model, g):
        opt = toptim.Optimizer(manager, toptim.sgd(LR)(model.parameters()), model)
        step = opt.make_step_fn(_loss)
        before = [p.detach().clone() for p in model.parameters()]
        loss, committed = step(torch.from_numpy(_tokens(g, 0)))
        assert not committed and manager.current_step() == 0
        assert all(torch.equal(p, p0) for p, p0 in zip(model.parameters(), before))
        with pytest.raises(RuntimeError, match="max_retries=1"):
            step(torch.from_numpy(_tokens(g, 1)))
        return manager.batches_committed()

    assert _port_groups(1, False, body, min_replica_size=2, max_retries=1) == [0]
