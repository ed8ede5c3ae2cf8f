"""The port's SLO-tiered scheduler against the reference's
(``repro.serving.scheduler``): the same handles and load signals give the
same queue order under aging, the same submit-time actions, victims and
decode groups."""
import types

import numpy as np
import pytest

from repro.serving import scheduler as jsched
from repro_torch.serving import scheduler as sched
from torch_threads import _one_thread  # noqa: F401


def _handle(i, qos, enqueue_s=0.0, max_new=16, done=0, preempts=0,
            exec_qos=None):
    return types.SimpleNamespace(
        id=i, qos=qos, exec_qos=exec_qos or qos, enqueue_s=enqueue_s,
        preempts=preempts, tokens=[0] * done,
        request=types.SimpleNamespace(max_new_tokens=max_new))


def _both(fn):
    return fn(sched), fn(jsched)


def test_constants_equal_reference():
    assert sched.QOS_CLASSES == jsched.QOS_CLASSES
    assert sched.QOS_WEIGHT == jsched.QOS_WEIGHT
    assert sched.WORKLOAD_QOS == jsched.WORKLOAD_QOS
    assert sched.SHED_POLICIES == jsched.SHED_POLICIES
    fields = lambda m: [(f.name, f.default) for f in
                        __import__("dataclasses").fields(m.SchedulerConfig)]
    assert fields(sched) == fields(jsched)


@pytest.mark.parametrize("seed", range(4))
def test_tiered_queue_order_and_aging_equal_reference(seed):
    """Random arrivals of all classes, popped under a moving clock with
    requeues (``appendleft``/``extendleft``) and a prune: the same
    sequence of handles out of both queues."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    qs = [m.TieredQueue(lambda: now[0], aging_s=0.5) for m in (sched,
                                                              jsched)]
    order = ([], [])
    for i in range(40):
        now[0] += float(rng.uniform(0, 0.3))
        h = _handle(i, sched.QOS_CLASSES[int(rng.integers(0, 3))],
                    enqueue_s=now[0])
        for q in qs:
            q.append(h)
        if rng.random() < 0.5:
            for q, out in zip(qs, order):
                if q:
                    out.append(q.peek().id)
                    out.append(q.popleft().id)
        if rng.random() < 0.2:
            for q in qs:
                if q:
                    a = q.popleft()
                    b = q.popleft() if q else None
                    q.extendleft([x for x in (a, b) if x is not None])
        if i == 20:
            pruned = [[h.id for h in q.prune(lambda h: h.id % 7 == 0)]
                      for q in qs]
            assert pruned[0] == pruned[1]
        assert qs[0].depths() == qs[1].depths()
        assert [h.id for h in qs[0]] == [h.id for h in qs[1]]
    while qs[0]:
        now[0] += 0.1
        for q, out in zip(qs, order):
            out.append(q.popleft().id)
    assert order[0] == order[1]
    assert not qs[1]


def test_aged_batch_outranks_fresh_premium_as_reference():
    for m in (sched, jsched):
        now = [0.0]
        q = m.TieredQueue(lambda: now[0], aging_s=1.0)
        q.append(_handle(0, "batch", enqueue_s=0.0))
        now[0] = 2.5
        q.append(_handle(1, "premium", enqueue_s=2.5))
        assert q.popleft().id == 0


LOADS = [dict(), dict(queue_depth=9.0), dict(est_wait_s=2.5),
         dict(budget_headroom_frac=0.01), dict(residency_ready_frac=0.2),
         dict(queue_depth=3.0, est_wait_s=0.1, budget_headroom_frac=0.5)]


@pytest.mark.parametrize("policy", ["none", "downgrade", "reject"])
@pytest.mark.parametrize("ready", [0.0, 0.5])
def test_admit_action_equal_reference(policy, ready):
    ours, ref = _both(lambda m: m.Scheduler(m.SchedulerConfig(
        shed_policy=policy, shed_min_ready_frac=ready)))
    for load in LOADS:
        assert ours.overloaded(load) == ref.overloaded(load)
        for qos in sched.QOS_CLASSES:
            assert ours.admit_action(qos, load) == \
                ref.admit_action(qos, load)


@pytest.mark.parametrize("seed", range(3))
def test_pick_victim_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for preemption in (True, False):
        ours, ref = _both(lambda m: m.Scheduler(m.SchedulerConfig(
            preemption=preemption, max_preempts=2)))
        for _ in range(20):
            running = [(i, _handle(i, sched.QOS_CLASSES[int(
                rng.integers(0, 3))], max_new=16,
                done=int(rng.integers(0, 16)),
                preempts=int(rng.integers(0, 3)))) for i in range(6)]
            for head in sched.QOS_CLASSES:
                a = ours.pick_victim(running, head)
                b = ref.pick_victim(running, head)
                assert (a is None) == (b is None)
                if a is not None:
                    assert a[0] == b[0]


def test_decode_groups_equal_reference():
    rows = [(i, _handle(i, q, exec_qos=e)) for i, (q, e) in enumerate([
        ("premium", None), ("batch", None), ("standard", "batch"),
        ("standard", None), ("batch", None)])]
    for spec_on in (False, True):
        ours, ref = _both(lambda m: m.Scheduler().decode_groups(rows,
                                                                spec_on))
        assert [(k, [i for i, _ in r]) for k, r in ours] == \
            [(k, [i for i, _ in r]) for k, r in ref]


@pytest.mark.parametrize("bad", [
    dict(qos_default="gold"), dict(shed_policy="drop"), dict(aging_s=0.0),
    dict(spec_tiers=("vip",)), dict(shed_headroom_frac=1.0),
    dict(shed_min_ready_frac=1.5), dict(prefill_chunk=-1)])
def test_validate_and_resolve_loud_as_reference(bad):
    for m in (sched, jsched):
        with pytest.raises(ValueError):
            m.SchedulerConfig(**bad).validate()
        with pytest.raises(ValueError):
            m.resolve_qos("gold", "standard")
        assert m.resolve_qos(None, "batch") == "batch"
