"""Kill and heal of a replica group in the port, held against the JAX package.

The drill, run in each package on the same converted weights: two replica
groups of FT-DDP with the fp8 bucket codec (the 2-layer f32 Llama of
test_torch_ddp.py, threads as groups, ``ProcessGroupNative``), the
lighthouse holding out for two groups. Group 1 starts from other weights
than group 0, so its step-0 ``init_sync`` heal is what makes them equal.
After committing step 0 it is killed (its manager, process group and store
shut down, the threads-as-replicas harness's kill), and a restart with a
third set of weights joins: the survivor waits in its step-1 quorum, the
restart heals from it at step 1 and both run to step 4. Step and commit
accounting equal the reference's exactly, the survivor fails no commit,
and the end parameters agree across the packages within the tolerance
test_torch_ddp.py states for the fp8 wire (here over four steps). Within
the port the groups end bitwise equal in parameters and optimizer state.

Then the Manager's heal rules, ported from the reference's mock-based
cases (tests/test_manager.py, tests/test_heal_hardening.py): a healing
replica sits out an async-quorum step and contributes zeros, a sync quorum
applies the heal before returning, a donor stages its state, the commit
barrier applies a pending heal, and failed attempts fail over and escalate.
Every group thread is joined with a timeout, and every train loop has an
iteration cap and a deadline.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional
from unittest.mock import MagicMock, create_autospec, patch

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
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.coordination import QuorumResult
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.models.convert import llama_state_dict_from_jax
from torchft_tpu_torch.parallel import native_pg as tpg
from torchft_tpu_torch.parallel import store as tstore
from torchft_tpu_torch.parallel.process_group import ProcessGroupDummy

torch.set_num_threads(1)

STEPS = 4
KILL_AT = 1
LR = 0.05
DRILL_DEADLINE_S = 90.0
FIELDS = dict(dim=256, ffn_hidden=512, loss_vocab_chunk=256, attention_impl="dense")
# As in test_torch_ddp.py: step-0 losses come from the same weights and
# tokens (f32 summation order); later ones see the parameter differences
# bounded below.
LOSS0_ATOL = 1e-5
LOSS_ATOL = 1e-3
# Step i's gradient in the updates of steps i..3 (SGD momentum 0.9).
MOMENTUM_WEIGHTS = tuple(sum(0.9**k for k in range(STEPS - i)) for i in range(STEPS))
# Each step of the drill, (committed, step, batches committed): step 0 has
# both groups in the max-step cohort (the init_sync heal), step 1 only the
# survivor (the restart heals), steps 2 and 3 both.
WANT_SURVIVOR = [(True, 1, 2), (True, 2, 3), (True, 3, 5), (True, 4, 7)]
WANT_GROUP1 = [(True, 1, 2), (True, 2, 3), (True, 3, 5), (True, 4, 7)]


def _tokens(group: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * group + step)
    return rng.integers(0, 512, (2, 33)).astype(np.int32)


def _drill(make_group: Callable[[int, int], Dict[str, Any]]):
    """Runs the survivor (group 0) and group 1 with its restart as threads;
    ``make_group(group, life)`` runs one life of one group and returns its
    record."""
    results: Dict[int, List[Dict[str, Any]]] = {0: [], 1: []}
    errors: List[BaseException] = []

    def run(group: int) -> None:
        try:
            lives = 2 if group == 1 else 1
            for life in range(lives):
                results[group].append(make_group(group, life))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(g,), daemon=True) for g in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DRILL_DEADLINE_S)
        assert not t.is_alive(), "a replica group did not finish in time"
    if errors:
        raise errors[0]
    return results


def _group_loop(manager, step_fn, group: int, life: int, to_tokens) -> List[tuple]:
    """The train loop of one life: until step STEPS, at most 2 * STEPS
    calls and DRILL_DEADLINE_S; group 1's first life ends at the top of
    step KILL_AT."""
    trace = []
    deadline = time.monotonic() + DRILL_DEADLINE_S
    for _ in range(2 * STEPS):
        if manager.current_step() >= STEPS or time.monotonic() > deadline:
            break
        if group == 1 and life == 0 and manager.current_step() == KILL_AT:
            break
        loss, committed = step_fn(to_tokens(_tokens(group + life, manager.current_step())))
        trace.append((float(loss), bool(committed), manager.current_step(),
                      manager.batches_committed()))
    return trace


@pytest.fixture(scope="module")
def weights():
    """Flax weights of the three lives (seeds 0, 1, 2) and their port copies."""
    jcfg = replace(jl.CONFIGS["tiny"], **FIELDS)
    jmodel = jl.Llama(jcfg)
    tcfg = replace(tl.CONFIGS["tiny"], **FIELDS)
    params = [jmodel.init(jax.random.PRNGKey(seed), _tokens(0, 0)[:, :-1]) for seed in range(3)]
    states = [llama_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p), tcfg)
              for p in params]
    return jmodel, params, states


def _jax_life(lighthouse, jmodel, params):
    def life_fn(group, life):
        store = jstore.StoreServer()
        pg = jpg.ProcessGroupNative(timeout=30.0)
        manager = jmanager.Manager(
            pg=pg, min_replica_size=1,
            store=jstore.StoreClient(store.address()), store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=f"jax{group}",
            timeout=30.0, quorum_timeout=30.0,
        )
        try:
            opt = joptim.Optimizer(manager, optax.sgd(LR, momentum=0.9), params[group + life])
            step = opt.make_step_fn(
                lambda p, t: jmodel.apply(p, t[:, :-1], targets=t[:, 1:]), should_quantize=True
            )
            trace = _group_loop(manager, step, group, life, lambda t: t)
            return {"trace": trace, "params": jax.tree_util.tree_map(np.asarray, opt.params),
                    "opt_state": jax.tree_util.tree_map(np.asarray, opt.opt_state)}
        finally:
            manager.shutdown(wait=False)
            pg.shutdown()
            store.shutdown()
    return life_fn


def _port_life(lighthouse, states):
    cfg = replace(tl.CONFIGS["tiny"], **FIELDS)

    def life_fn(group, life):
        store = tstore.StoreServer()
        pg = tpg.ProcessGroupNative(timeout=30.0)
        manager = tmanager.Manager(
            pg=pg, min_replica_size=1,
            store=tstore.StoreClient(store.address()), store_addr=store.address(),
            lighthouse_addr=lighthouse.address(), replica_id=f"port{group}",
            timeout=30.0, quorum_timeout=30.0,
        )
        try:
            model = tl.Llama(cfg, device="cpu")
            model.load_state_dict(states[group + life], strict=True)
            opt = toptim.Optimizer(manager, toptim.sgd(LR, momentum=0.9)(model.parameters()), model)
            step = opt.make_step_fn(lambda m, t: m(t[:, :-1], targets=t[:, 1:]),
                                    should_quantize=True)
            grad_max: List[Dict[str, float]] = []

            def step_and_record(tokens):
                out = step(tokens)
                grad_max.append({n: p.grad.abs().max().item()
                                 for n, p in model.named_parameters()})
                return out

            trace = _group_loop(manager, step_and_record, group, life, torch.from_numpy)
            return {"trace": trace, "grad_max": grad_max, "heals": opt._heal_count,
                    "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                    "momentum": [s["momentum_buffer"].clone()
                                 for s in opt.optimizer.state_dict()["state"].values()]}
        finally:
            manager.shutdown(wait=False)
            pg.shutdown()
            store.shutdown()
    return life_fn


def test_kill_and_heal_drill_matches_the_jax_package(weights, monkeypatch):
    monkeypatch.setenv("TPUFT_BUCKET_MB", "0.25")
    monkeypatch.setenv("TPUFT_WIRE_DTYPE", "fp8")
    jmodel, params, states = weights

    tlight = tcoord.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    try:
        port = _drill(_port_life(tlight, states))
    finally:
        tlight.shutdown()
    jlight = jcoord.LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=100)
    try:
        ref = _drill(_jax_life(jlight, jmodel, params))
    finally:
        jlight.shutdown()

    def accounting(lives):
        return [t[1:] for life in lives for t in life["trace"]]

    # Step accounting: exact, equal across the packages, no failed commit.
    assert accounting(port[0]) == accounting(ref[0]) == WANT_SURVIVOR
    assert accounting(port[1]) == accounting(ref[1]) == WANT_GROUP1
    assert [len(life["trace"]) for life in port[1]] == [KILL_AT, STEPS - KILL_AT]
    # The init_sync heal and the restart's heal, once each, in group 1.
    assert port[0][0]["heals"] == 0 and [life["heals"] for life in port[1]] == [1, 1]

    # Within the port: bitwise equal parameters and optimizer state.
    survivor, restart = port[0][0], port[1][1]
    for name, value in survivor["params"].items():
        assert torch.equal(value, restart["params"][name]), name
    assert len(survivor["momentum"]) == len(restart["momentum"]) > 0
    for a, b in zip(survivor["momentum"], restart["momentum"]):
        assert torch.equal(a, b)
    # Within the reference too (its own contract).
    for a, b in zip(jax.tree_util.tree_leaves(ref[0][0]["params"]),
                    jax.tree_util.tree_leaves(ref[1][1]["params"])):
        np.testing.assert_array_equal(a, b)

    # Losses and end parameters across the packages.
    for p_lives, j_lives in ((port[0], ref[0]), (port[1], ref[1])):
        for p_life, j_life in zip(p_lives, j_lives):
            p_losses = [t[0] for t in p_life["trace"]]
            j_losses = [t[0] for t in j_life["trace"]]
            np.testing.assert_allclose(p_losses[0], j_losses[0], atol=LOSS0_ATOL, rtol=0)
            np.testing.assert_allclose(p_losses, j_losses, atol=LOSS_ATOL, rtol=0)
    tcfg = replace(tl.CONFIGS["tiny"], **FIELDS)
    want = llama_state_dict_from_jax(ref[0][0]["params"], tcfg)
    grad_max = survivor["grad_max"]
    for name, value in want.items():
        tol = LR * sum(w * 2 * g[name] / 14 for w, g in zip(MOMENTUM_WEIGHTS, grad_max)) + 1e-6
        err = (survivor["params"][name] - value).abs().max().item()
        assert err <= tol, f"{name}: {err} > {tol}"


# -- the Manager's heal rules, on mocks ------------------------------------------


class _FakeStore:
    def __init__(self) -> None:
        self.data = {"manager_addr": b"fake:1234", "replica_id": b"test_replica:uuid"}

    def get(self, key: str, timeout: float = 0, wait: bool = True):
        return self.data.get(key)

    def set(self, key: str, value: bytes, timeout: float = 0) -> None:
        self.data[key] = value


def _quorum(quorum_id=1, replica_rank=0, replica_world_size=2, heal=False, max_step=0,
            max_rank: Optional[int] = None, max_world_size=2, recover_src_manager_address="",
            recover_src_replica_rank=None, recover_dst_replica_ranks=()):
    if max_rank is None and not heal:
        max_rank = replica_rank
    return QuorumResult(
        quorum_id=quorum_id, replica_rank=replica_rank, replica_world_size=replica_world_size,
        recover_src_manager_address=recover_src_manager_address,
        recover_src_replica_rank=recover_src_replica_rank,
        recover_dst_replica_ranks=list(recover_dst_replica_ranks), store_address="store:0",
        max_step=max_step, max_rank=max_rank, max_world_size=max_world_size, heal=heal,
    )


def _heal_quorum(addr: str, quorum_id: int = 2, max_step: int = 5, max_world_size: int = 1):
    return _quorum(quorum_id=quorum_id, replica_rank=1, heal=True, max_step=max_step,
                   max_world_size=max_world_size, recover_src_manager_address=addr,
                   recover_src_replica_rank=0)


def _manager(use_async_quorum=True, min_replica_size=2, **kwargs):
    transport = create_autospec(CheckpointTransport, instance=True)
    transport.metadata.return_value = "http://fake:0"
    with patch("torchft_tpu_torch.manager.ManagerClient", autospec=True):
        manager = tmanager.Manager(
            pg=ProcessGroupDummy(), min_replica_size=min_replica_size, store=_FakeStore(),
            store_addr="store:0", use_async_quorum=use_async_quorum,
            group_rank=1,  # no native ManagerServer
            group_world_size=2, checkpoint_transport=transport, timeout=5.0,
            quorum_timeout=5.0, **kwargs,
        )
    load_fn = MagicMock()
    manager.register_state_dict_fn("model", load_fn, lambda: {"w": torch.ones(2)})
    return manager, manager._client, transport, load_fn


def _healed(step=5, batches=10):
    return {"user": {"model": {"w": torch.full((2,), 9.0)}},
            "tpuft": {"step": step, "batches_committed": batches}}


def test_healing_async_skips_participation_and_zeroes_grads():
    manager, client, transport, load_fn = _manager()
    client._quorum.return_value = _heal_quorum("donor:1")
    client.should_commit.return_value = True
    transport.recv_checkpoint.return_value = _healed()
    with patch("torchft_tpu_torch.manager.ManagerClient", autospec=True) as donor_cls:
        donor_cls.return_value._checkpoint_metadata.return_value = "http://donor:0"
        manager.start_quorum()
        manager.wait_quorum()
    assert manager._healing and not manager.is_participating()
    assert manager.num_participants() == 1
    assert transport.recv_checkpoint.call_args[1]["metadata"] == "http://donor:0"
    out = manager.allreduce(torch.tensor([3.0, 3.0])).wait()
    assert torch.equal(out, torch.zeros(2))  # a healing replica contributes zeros
    assert manager.current_step() == 5  # accounting restored from the donor
    load_fn.assert_not_called()
    assert manager.should_commit()  # the barrier applies the pending state
    load_fn.assert_called_once()
    assert torch.equal(load_fn.call_args[0][0]["w"], torch.full((2,), 9.0))
    assert manager.current_step() == 6
    transport.disallow_checkpoint.assert_called()
    manager.shutdown(wait=False)


def test_healing_sync_applies_before_return():
    manager, client, transport, load_fn = _manager(use_async_quorum=False)
    client._quorum.return_value = _heal_quorum("donor:1", max_step=2)
    transport.recv_checkpoint.return_value = _healed(2, 4)
    with patch("torchft_tpu_torch.manager.ManagerClient", autospec=True):
        manager.start_quorum()
    assert not manager._healing
    load_fn.assert_called_once()
    assert manager.is_participating() and manager.num_participants() == 2
    manager.shutdown(wait=False)


def test_donor_stages_its_state_with_the_quorum_era():
    manager, client, transport, _ = _manager()
    client._quorum.return_value = _quorum(quorum_id=13, recover_dst_replica_ranks=[1])
    manager.start_quorum()
    manager.wait_quorum()
    kwargs = transport.send_checkpoint.call_args[1]
    assert kwargs["dst_ranks"] == [1] and kwargs["quorum_id"] == 13 and kwargs["step"] == 0
    assert set(kwargs["state_dict"]) == {"user", "tpuft"}
    assert torch.equal(kwargs["state_dict"]["user"]["model"]["w"], torch.ones(2))
    assert client._quorum.call_args[1]["checkpoint_metadata"] == "http://fake:0"
    manager.shutdown(wait=False)


def test_should_commit_async_applies_a_pending_heal():
    manager, client, transport, load_fn = _manager(use_async_quorum=False, min_replica_size=1)
    client._quorum.return_value = _quorum()
    client.should_commit.side_effect = lambda rank, step, vote, timeout: vote
    manager.start_quorum()
    assert manager.should_commit_async().result(timeout=10) is True
    assert manager.current_step() == 1
    client._quorum.return_value = _heal_quorum("donor:1", max_world_size=2)
    transport.recv_checkpoint.return_value = _healed(5, 5)
    with patch("torchft_tpu_torch.manager.ManagerClient", autospec=True):
        manager.start_quorum()
    load_fn.assert_called_once()
    assert manager.current_step() == 5
    assert manager.should_commit_async().result(timeout=10) is True
    assert manager.current_step() == 6
    manager.shutdown(wait=False)


def test_heal_failover_accounting_and_bounded_attempts():
    """Donor A fails; A again: skipped once without a transfer; donor B
    fails: the attempt budget (2) is spent and HealExhaustedError leaves
    the quorum future."""
    from torchft_tpu_torch import metrics

    manager, client, transport, load_fn = _manager(min_replica_size=1, heal_max_attempts=2)
    labels = manager._metric_labels
    transport.recv_checkpoint.side_effect = RuntimeError("donor died")
    f0 = metrics.counter_total("tpuft_heal_donor_failovers_total", **labels)
    r0 = metrics.counter_total("tpuft_heal_retries_total", **labels)
    with patch("torchft_tpu_torch.manager.ManagerClient", autospec=True) as donor_cls:
        donor_cls.return_value._checkpoint_metadata.return_value = "http://donor:0"
        client._quorum.return_value = _heal_quorum("donor_a:1")
        manager.start_quorum()
        manager.wait_quorum()
        assert manager.errored() is not None and manager._heal_attempts == 1
        client.should_commit.side_effect = lambda rank, step, vote, timeout: vote
        assert not manager.should_commit()  # a failed heal never commits
        load_fn.assert_not_called()

        manager.start_quorum()
        manager.wait_quorum()
        assert transport.recv_checkpoint.call_count == 1 and manager._heal_attempts == 1

        client._quorum.return_value = _heal_quorum("donor_b:1")
        manager.start_quorum()
        with pytest.raises(tmanager.HealExhaustedError):
            manager.wait_quorum()
    assert transport.recv_checkpoint.call_count == 2
    assert metrics.counter_total("tpuft_heal_donor_failovers_total", **labels) - f0 == 1
    assert metrics.counter_total("tpuft_heal_retries_total", **labels) - r0 == 2
    manager.shutdown(wait=False)


def test_optimizer_heal_loads_host_tensors_in_the_parameters_dtype():
    """The healed state arrives as host tensors: the model copies them into
    its parameters, torch's optimizer casts its state to each parameter's
    dtype and device, and the heal is counted."""
    manager = MagicMock()
    model = torch.nn.Linear(4, 2, dtype=torch.bfloat16)
    opt = toptim.Optimizer(manager, toptim.sgd(0.1, momentum=0.9)(model.parameters()), model)
    load_fn = manager.register_state_dict_fn.call_args[0][1]
    donor = torch.nn.Linear(4, 2, dtype=torch.bfloat16)
    donor_opt = torch.optim.SGD(donor.parameters(), lr=0.1, momentum=0.9)
    donor(torch.ones(1, 4, dtype=torch.bfloat16)).sum().backward()
    donor_opt.step()
    state = {"model": {k: v.clone() for k, v in donor.state_dict().items()},
             "optimizer": donor_opt.state_dict()}
    load_fn(state)
    assert opt._heal_count == 1
    for p, q in zip(model.parameters(), donor.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q)
    for s in opt.optimizer.state.values():
        assert s["momentum_buffer"].dtype == torch.bfloat16
