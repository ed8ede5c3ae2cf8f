"""The expert-parallel bookkeeping of the port in one process, held to the
reference's objects: the same operation sequences on the reference's
``ShardedSlotPool``, per-shard ``TransitionManager`` budgets and
``EPCoordinator``, and on the port's, compared step by step (slots,
tracker bytes, hi sets, placements, swapped router columns and lo rows).
The reference's ``tests/test_expert_parallel.py`` accounting tests, run
on both packages. No process group: one process holds every shard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ControllerConfig as JControllerConfig
from repro.core import DynaExqController as JDynaExqController
from repro.core import build_bank as jbuild_bank
from repro.core import expert_hi_nbytes as jexpert_hi_nbytes
from repro.core.budget import BudgetTracker as JBudgetTracker
from repro.core.controller import EPCoordinator as JEPCoordinator
from repro.core.controller import RebalanceConfig as JRebalanceConfig
from repro.core.pools import ShardedSlotPool as JShardedSlotPool
from repro_torch.convert import bank_from_reference, to_numpy, to_torch
from repro_torch.core import (BudgetTracker, ControllerConfig,
                              DynaExqController, EPCoordinator,
                              RebalanceConfig, expert_hi_nbytes)
from repro_torch.core.pools import ShardedSlotPool
from torch_threads import _one_thread  # noqa: F401


def _pool_ops(pool_cls):
    """The reference's ``test_sharded_slot_pool`` sequence; returns what
    each step gave."""
    seen = []
    p = pool_cls(8, 4)                 # 2 slots per shard
    seen.append((p.per_shard, p.n_free))
    seen.append((p.alloc(0, shard=0), p.alloc(1, shard=0)))
    seen.append((p.n_free_in(0), p.n_free_in(3)))
    with pytest.raises(RuntimeError):
        p.alloc(2, shard=0)            # shard-local exhaustion, not global
    s2 = p.alloc(9, shard=3)
    seen.append((s2, p.shard_of(s2)))
    p.free(seen[1][0])
    seen.append(p.n_free_in(0))
    seen.append(p.alloc(4, shard=0))   # lowest-index-first within the shard
    seen.append(p.slots_of())
    with pytest.raises(ValueError):
        pool_cls(6, 4)                 # must divide evenly
    return seen


def test_sharded_slot_pool():
    got, want = _pool_ops(ShardedSlotPool), _pool_ops(JShardedSlotPool)
    assert got == want
    assert want[1] == (0, 1) and want[3] == (6, 3) and want[5] == 0


def _weights(L=1, E=8):
    w = jax.random.normal(jax.random.PRNGKey(0), (L, E, 64, 32),
                          jnp.float32).astype(jnp.bfloat16)
    return {"w": np.asarray(w)}


def _controllers(L=1, E=8, n_hi=4, n_shards=4, shared_budget=False):
    """The reference's ``_make_ep_controller`` on both packages: (reference
    controller, its trackers), (port controller, its trackers), hi bytes.
    The port's bank is the reference's, converted: both start from the
    same lo rows."""
    w = _weights(L, E)
    jbank = jbuild_bank({k: jnp.asarray(v) for k, v in w.items()},
                        n_hi=n_hi, lo_bits=4)
    hib = jexpert_hi_nbytes({k: v.shape for k, v in w.items()})
    assert hib == expert_hi_nbytes({k: v.shape for k, v in w.items()})
    per_cap = (n_hi // n_shards) * L * hib
    out = []
    for tracker_cls, ctl_cls, cfg, bank, host in (
            (JBudgetTracker, JDynaExqController,
             JControllerConfig(update_interval_s=1e9), jbank, w),
            (BudgetTracker, DynaExqController,
             ControllerConfig(update_interval_s=1e9),
             bank_from_reference(jbank),
             {k: to_torch(v) for k, v in w.items()})):
        if shared_budget:
            parent = tracker_cls(n_hi * L * hib)
            trackers = [parent.view(f"s{j}", cap=per_cap)
                        for j in range(n_shards)]
        else:
            trackers = [tracker_cls(per_cap) for _ in range(n_shards)]
        ctl = ctl_cls(bank, host, n_hi_per_layer=n_hi,
                      hi_bytes_per_expert=hib, cfg=cfg, ep_shards=n_shards,
                      shard_trackers=trackers)
        out.append((ctl, trackers))
    return out[0], out[1], hib


def _books(ctl, trackers):
    tm = ctl.tm
    return (sorted(tm.hi_set(0)), tm.stats["deferred"],
            [t.used for t in trackers], tm.slot_map_h.tolist(),
            tm.slot_owner_h.tolist(), tm.state.tolist())


def _lo(ctl):
    q = ctl.bank.lo["w"]
    if isinstance(q.packed, torch.Tensor):     # copies: swaps are in place
        return to_numpy(q.packed).copy(), to_numpy(q.scales).copy()
    return np.asarray(q.packed), np.asarray(q.scales).view(np.uint16)


@pytest.mark.parametrize("shared_budget", [False, True])
def test_per_shard_budget_isolation(shared_budget):
    """The reference's sequence on both packages, compared after every
    step: a hot shard's full slot defers ITS promotion only, its sibling
    shard admits; a demotion frees the slot for the deferred one; a
    relabel of 1 ↔ 7 across shards 0/3 (expert 1 demoted first) swaps the
    router columns and lo rows; a full demotion returns every shard's
    account to zero."""
    (jctl, jtr), (tctl, ttr), hib = _controllers(shared_budget=shared_budget)
    np.testing.assert_array_equal(_lo(tctl)[0], _lo(jctl)[0])
    np.testing.assert_array_equal(_lo(tctl)[1], _lo(jctl)[1])
    steps = []
    for ctl, trackers in ((jctl, jtr), (tctl, ttr)):
        tm = ctl.tm
        books = []
        for e in (0, 1, 2):           # 0 and 1 share shard 0's one slot
            tm.request_promotion(0, e)
        tm.drain()
        tm.publish_ready(wait=True)
        tm.check_invariants()
        books.append(_books(ctl, trackers))
        tm.request_demotion(0, 0)
        for _ in range(2):
            tm.drain()
            tm.publish_ready(wait=True)
        tm.check_invariants()
        books.append(_books(ctl, trackers))
        steps.append(books)
    assert steps[0] == steps[1]
    assert steps[0][0][0] == [0, 2] and steps[0][0][1] >= 1
    assert steps[0][0][2] == [hib, hib, 0, 0]
    assert steps[0][1][0] == [1, 2]

    router = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 16, 8),
                                          jnp.float32))
    jmoe = {"router": jnp.asarray(router)}
    tmoe = {"router": torch.from_numpy(router.copy())}
    lo_before = _lo(tctl)
    jco = JEPCoordinator(4, JRebalanceConfig(interval_s=1e9))
    tco = EPCoordinator(4, RebalanceConfig(interval_s=1e9))
    jco.register(jctl, jmoe)
    tco.register(tctl, tmoe)
    assert jco._migrate(jctl, jmoe, jco._entries[0][2], 0, 1, 7)
    assert tco._migrate(tctl, tmoe, tco._entries[0][2], 0, 1, 7)
    np.testing.assert_array_equal(tmoe["router"].numpy(),
                                  np.asarray(jmoe["router"]))
    np.testing.assert_array_equal(tmoe["router"].numpy()[0, :, [1, 7]],
                                  router[0, :, [7, 1]])
    for got, want, before in zip(_lo(tctl), _lo(jctl), lo_before):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, [1, 7]], before[0, [7, 1]])
    np.testing.assert_array_equal(tco._entries[0][2], jco._entries[0][2])
    assert tco.stats == jco.stats
    assert _books(tctl, ttr) == _books(jctl, jtr)
    assert tctl.tm.hi_set(0) == {2}    # expert 1 was demoted first
    tctl.tm.check_invariants()

    for ctl, trackers in ((jctl, jtr), (tctl, ttr)):
        for e in sorted(ctl.tm.hi_set(0)):
            ctl.tm.request_demotion(0, e)
        ctl.tm.drain()
        ctl.tm.publish_ready(wait=True)
        ctl.tm.check_invariants()
        assert all(t.used == 0 for t in trackers)
    assert _books(tctl, ttr) == _books(jctl, jtr)


def test_rebalance_improvement_guard():
    """The coordinator migrates only when the swap strictly shrinks the max
    shard load: with one expert per shard never; with two, exactly once
    for a moderate skew; the same placements in both packages."""
    placements = []
    for E, n_shards, skew, want in ((4, 4, (1000,), 0),
                                    (8, 2, (100, 100), 1)):
        (jctl, _), (tctl, _), _ = _controllers(E=E, n_hi=4,
                                               n_shards=n_shards)
        jco = JEPCoordinator(n_shards, JRebalanceConfig(
            interval_s=1e9, max_migrations_per_window=4))
        tco = EPCoordinator(n_shards, RebalanceConfig(
            interval_s=1e9, max_migrations_per_window=4))
        jco.register(jctl, {"router": jnp.zeros((1, 16, E), jnp.float32)})
        tco.register(tctl, {"router": torch.zeros((1, 16, E))})
        for ctl in (jctl, tctl):
            for e, c in enumerate(skew):
                ctl.hotness.counts[:, e] += c
        assert jco.maybe_rebalance(force=True) == want
        assert tco.maybe_rebalance(force=True) == want
        np.testing.assert_array_equal(tco._entries[0][2],
                                      jco._entries[0][2])
        placements.append(tco._entries[0][2])
    assert np.array_equal(placements[0], np.tile(np.arange(4), (1, 1)))
    assert not np.array_equal(placements[1], np.tile(np.arange(8), (1, 1)))


def test_backend_ep_validation():
    """The reference's refusals, in its words, on both packages' backends:
    E not divisible by the shards, n_hi not divisible, ep_shards < 1, and
    the global allocator under expert parallelism."""
    from repro.configs import get_config as jget_config
    from repro.models import init_params as jinit_params
    from repro.serving.backends import make_backend as jmake_backend
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.backends import make_backend

    jcfg = jget_config("granite-moe-1b-a400m", reduced=True)   # E=4
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    for kw, match in ((dict(ep_shards=3, n_hi_per_layer=3), "not divisible"),
                      (dict(ep_shards=2, n_hi_per_layer=3),
                       "n_hi_per_layer")):
        with pytest.raises(ValueError, match=match) as jerr:
            jmake_backend("dynaexq", **kw).materialize_banks(
                jcfg, jinit_params(jax.random.PRNGKey(0), jcfg), kv_bytes=0)
        with pytest.raises(ValueError, match=match) as terr:
            make_backend("dynaexq", device="cpu", **kw).materialize_banks(
                cfg, init_params(cfg, device="cpu"), kv_bytes=0)
        assert str(terr.value) == str(jerr.value)
    for kw in (dict(ep_shards=0), dict(ep_shards=2, global_alloc=True)):
        with pytest.raises(ValueError) as jerr:
            jmake_backend("dynaexq", **kw)
        with pytest.raises(ValueError) as terr:
            make_backend("dynaexq", device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
