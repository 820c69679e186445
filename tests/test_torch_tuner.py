"""The latency-budget batch sizing against the JAX package's: on the
same seeded (padded size, cycle seconds) sequences ``_tune_chunk`` and
``_select_pad`` give the same chunk, pad and warm requests;
``SolverSession.warm_pad`` leaves the carried state and static planes
bit for bit as they were, the session valid, and a held batch's commit
unchanged; a row whose budget is cut after its warm-up steps its pad
down one bucket a batch, warming each new bucket between cycles, with no
compile inside a measured cycle."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.sidecar import TPUBatchScheduler
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.apiserver.store import ClusterStore
from kubernetes_tpu_torch.harness import perf, workloads
from kubernetes_tpu_torch.observability.devprof import get_devprof
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.sidecar import BatchScheduler


def _tuner(cls, max_batch, adaptive=True):
    """The tuner's state alone (no scheduler): the fields ``_tune_chunk``
    and ``_select_pad`` read, as both constructors set them."""
    t = cls.__new__(cls)
    t.max_batch, t.adaptive_chunk, t._chunk = max_batch, adaptive, max_batch
    t._warmed_pads, t._need_warm_pad = {max_batch}, None
    return t


def test_budget_constants_equal_the_reference():
    assert BatchScheduler.LATENCY_BUDGET_S == \
        TPUBatchScheduler.LATENCY_BUDGET_S
    assert BatchScheduler.MIN_CHUNK == TPUBatchScheduler.MIN_CHUNK


@pytest.mark.parametrize("seed,max_batch,adaptive", [
    (0, 4096, True), (1, 4096, True), (2, 2048, True), (3, 128, True),
    (4, 4096, False)])
def test_tune_and_select_equal_the_reference(seed, max_batch, adaptive):
    ref = _tuner(TPUBatchScheduler, max_batch, adaptive)
    port = _tuner(BatchScheduler, max_batch, adaptive)
    rng = np.random.default_rng(seed)
    chunks = set()
    for _ in range(300):
        n = int(rng.integers(1, max_batch + 1))
        pad = port._select_pad(n)
        assert pad == ref._select_pad(n)
        seconds = float(rng.choice([rng.uniform(0.001, 0.2),
                                    rng.uniform(0.5, 6.0)]))
        for t in (ref, port):
            t._warmed_pads.add(pad)      # the solve ran at this pad
            t._tune_chunk(pad, seconds)
        assert (port._chunk, port._need_warm_pad) == (ref._chunk,
                                                      ref._need_warm_pad)
        chunks.add(port._chunk)
        if port._need_warm_pad is not None and rng.random() < 0.6:
            for t in (ref, port):        # the warm between cycles
                t._warmed_pads.add(t._need_warm_pad)
                t._need_warm_pad = None
    if adaptive and max_batch > BatchScheduler.MIN_CHUNK:
        assert len(chunks) > 2
    else:
        assert chunks == {max_batch}


def _cluster(nodes, pods, max_batch, pipeline):
    store = ClusterStore()
    sched = Scheduler(store)
    bs = BatchScheduler(sched, max_batch=max_batch, device="cpu",
                        pipeline=pipeline)
    sched.start()
    for i in range(nodes):
        store.add_node(Node.from_dict(workloads.node_template(i)))
    store.create_pods([Pod.from_dict(workloads.basic_pod(i))
                       for i in range(pods)])
    return store, sched, bs


def test_warm_pad_leaves_the_carried_state_alone():
    placements = []
    for warm in (False, True):
        store, sched, bs = _cluster(20, 96, 32, pipeline=True)
        bs.run_batch(pop_timeout=0.0)
        bs.run_batch(pop_timeout=0.0)
        assert bs.holding
        session = bs.session
        state = session._state.clone()
        static = (session._static.ints.clone(), session._static.f32s.clone())
        rebuilds, valid = session.rebuilds, session.mirror_current()
        if warm:
            samples = [q.pod for q, _ in bs._pending["batch"][:8]]
            assert session.warm_pad(samples, 64) == 0
            assert torch.equal(session._state, state)
            assert torch.equal(session._static.ints, static[0])
            assert torch.equal(session._static.f32s, static[1])
            assert (session.rebuilds, session.mirror_current()) == (
                rebuilds, valid)
        while bs.run_batch(pop_timeout=0.0):
            pass
        bs.flush()
        placements.append({p.name: p.spec.node_name
                           for p in store.list_pods()})
        assert session.rebuilds == rebuilds
        sched.stop()
    assert placements[0] == placements[1] and all(placements[1].values())


@pytest.mark.parametrize("pipeline", [True, False])
def test_cut_budget_steps_the_pad_down_with_warms_between_cycles(pipeline):
    pads, warms = [], []

    def configure(bs):
        warmup, solve = bs.warmup, bs.session.solve
        warm_pad = bs.session.warm_pad

        def warm_pad_at(pods, pad):
            warms.append((pad, len(pads)))
            return warm_pad(pods, pad)

        def cut_after_warmup(samples):
            out = warmup(samples)
            bs.LATENCY_BUDGET_S = 1e-6
            return out

        def solve_at(pods, pad, **kw):
            if not kw.get("warming"):
                pads.append(pad)
            return solve(pods, pad, **kw)

        bs.warmup, bs.session.solve = cut_after_warmup, solve_at
        bs.session.warm_pad = warm_pad_at

    res = perf.run_workload(
        "SchedulingBasic", workloads.make_workload("SchedulingBasic", 200, 0,
                                                   6000),
        device="cpu", max_batch=2048, pipeline=pipeline, configure=configure)
    assert all(res.placements.values())
    # the warm-up warmed 2048 and 1024; 512 was warmed between cycles
    assert pads[0] == 2048 and 512 in pads
    assert all(b in (a, a // 2) for a, b in zip(pads, pads[1:]))
    assert res.chunk == 512 and res.warmed_pads == [512, 1024, 2048]
    # the warm-up warmed 1024 on a copy; one warm between cycles, before
    # the first solve at 512
    assert [pad for pad, solves in warms if solves == 0] == [1024]
    ((pad, solves_before),) = [w for w in warms if w[1] > 0]
    assert pad == 512 and pads.index(512) == solves_before
    warm_cycles = [c for c in get_devprof().cycles(include_warming=True)
                   if c["warming"] and c["pad"] == 512]
    assert len(warm_cycles) == 1 and warm_cycles[0]["real"] == 8
    assert res.telemetry["unexpected_compiles"] == 0
