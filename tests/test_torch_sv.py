"""The shared-volume attach planes (``sv``) in the port against the JAX
package: the plain solve with ``sv`` against ``_xla_planes_solve(...,
sv=)`` on seeded planes (SV of 8 and 64, sentinel pods mixed in, full
nodes, volumes attached by one pod and reused by a later pod of the same
batch), ``pack_podin``'s two extra columns, ``from_reference`` carrying
the JAX package's planes across, and the routing rules: no slot stream
for an ``sv`` epoch, the launch plan's two extra pod columns. Tolerance:
exact, for assignments and planes alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import pallas_solver as jps
from kubernetes_tpu.ops.encode import EncodedBatch as JaxBatch
from kubernetes_tpu.ops.solver import (
    SolverParams as JaxParams,
    pack_podin as jax_pack_podin,
)
from kubernetes_tpu_torch.harness.problems import random_planes
from kubernetes_tpu_torch.ops import solve as solve_mod
from kubernetes_tpu_torch.ops.encode import EncodedPodBatch
from kubernetes_tpu_torch.ops.planes import from_reference, state_planes
from kubernetes_tpu_torch.ops.solve import (
    CudaPlanesBackend,
    cluster_smem_bytes,
    plan_launch,
    solve_kernel,
    solve_plain,
    solve_plain_slots,
)
from kubernetes_tpu_torch.ops.solver import SolverParams, pack_podin


def jax_sv_solve(ps, state, ints, floats):
    nb = ps.ints.shape[1] // 128
    planes, assign = jps._xla_planes_solve(
        JaxParams(), ps.r, ps.sc, ps.t, ps.u, ps.v,
        jnp.asarray(ps.sc_meta.numpy()),
        jnp.asarray(ps.ints.numpy().reshape(-1, nb, 128)),
        jnp.asarray(ps.f32s.numpy().reshape(ps.u, nb, 128)),
        jnp.asarray(state.numpy().reshape(-1, nb, 128)),
        jnp.asarray(ints.numpy()), jnp.asarray(floats.numpy()), sv=ps.sv)
    return np.asarray(assign), np.asarray(planes).reshape(state.shape)


def _reuses(ps, state0, ints, got):
    """Pods placed where an earlier pod of the batch attached their
    volume."""
    c = ps.r + 4 + 2 * ps.sc + 3 * ps.t
    do, _ = state_planes(ps.r, ps.sc, ps.t, ps.sv)
    attached = set()
    reused = 0
    for row, a in zip(ints.tolist(), got.tolist()):
        slot = row[c]
        if a < 0 or slot >= ps.sv:
            continue
        if (slot, a) in attached and not bool(
                state0[do["sv_attached"] + slot, a]):
            reused += 1
        attached.add((slot, a))
    return reused


@pytest.mark.parametrize("seed,n,b,sv,sc,t", [
    (0, 256, 96, 8, 1, 1),
    (1, 384, 128, 64, 2, 3),
    (2, 256, 160, 8, 3, 2),
])
def test_plain_sv_solve_matches_xla_planes_solve(seed, n, b, sv, sc, t):
    ps, state, ints, floats = random_planes(seed, n, b, r=4, sc=sc, t=t,
                                            u=2, real=n - 30, sv=sv)
    state0 = state.clone()
    want, want_planes = jax_sv_solve(ps, state, ints, floats)
    got = solve_plain(SolverParams(), ps, state, ints, floats)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), want_planes)
    c = ps.r + 4 + 2 * sc + 3 * t
    valid = ints[:, ps.r + 3] > 0
    # the case exercises what it names: sentinel and slotted pods placed,
    # full nodes, volumes reused within the batch
    assert bool(((ints[:, c] == sv) & valid & (got >= 0)).any())
    assert bool(((ints[:, c] < sv) & valid & (got >= 0)).any())
    do, _ = state_planes(ps.r, sc, t, sv)
    col = ps.r - 1
    assert bool((state0[do["requested"] + col]
                 >= ps.ints[col]).any())
    assert _reuses(ps, state0, ints, got) > 0
    # the attached rows only gain bits
    rows = slice(do["sv_attached"], do["sv_attached"] + sv)
    assert bool((state[rows] >= state0[rows]).all())


def test_plain_sv_solve_equals_without_slots_when_no_pod_references_one():
    """Every pod on the sentinel slot: the same assignments as the
    planes without ``sv`` rows and columns."""
    ps, state, ints, floats = random_planes(3, 256, 64, r=4, sv=8)
    c = ps.r + 4 + 2 * ps.sc + 3 * ps.t
    ints[:, c], ints[:, c + 1] = 8, 0
    do, _ = state_planes(ps.r, ps.sc, ps.t, 8)
    plain_state = torch.cat([state[:do["sv_attached"]], state[-1:]])
    plain_ps = ps._replace(sv=0)
    want = solve_plain(SolverParams(), plain_ps, plain_state,
                       ints[:, :c].contiguous(), floats)
    got = solve_plain(SolverParams(), ps, state, ints, floats)
    assert torch.equal(got, want)


def test_pack_podin_appends_the_slot_and_attach_column():
    rng = np.random.default_rng(4)
    b, r, sc, t = 16, 4, 2, 3
    fields = dict(
        requests=rng.integers(0, 9, (b, r)).astype(np.int32),
        nonzero_requests=rng.integers(0, 9, (b, 2)).astype(np.int32),
        profile_idx=rng.integers(0, 3, b).astype(np.int32),
        inexpressible=rng.random(b) < 0.2,
        pod_sc=rng.random((b, sc)) < 0.5,
        pod_sc_match=rng.random((b, sc)) < 0.5,
        match_by=rng.random((b, t)) < 0.5,
        own_aff=rng.random((b, t)) < 0.5,
        own_anti=rng.random((b, t)) < 0.5,
        pref_weight=rng.random((b, t)).astype(np.float32),
    )
    pod_sv = np.stack([rng.integers(0, 9, b), np.full(b, 3)],
                      axis=1).astype(np.int32)
    for sv in (None, pod_sv):
        port = EncodedPodBatch(pods=[], num_real_pods=13, pod_sv=sv,
                               **fields)
        ref = JaxBatch(pods=[], num_real_pods=13, static_masks=None,
                       affinity_masks=None, static_scores=None,
                       sc_key_idx=None, sc_max_skew=None, sc_hard=None,
                       sc_counts=None, sc_domain=None, term_key_idx=None,
                       term_counts=None, term_owners=None, num_values=1,
                       pod_sv=sv, **fields)
        got, want = pack_podin(port), jax_pack_podin(ref)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype
            np.testing.assert_array_equal(a, w)
        width = r + 4 + 2 * sc + 3 * t
        assert got[0].shape == (b, width + (0 if sv is None else 2))


def test_from_reference_carries_the_sv_planes():
    """Packed JAX planes with ``sv`` rows come across as the same state,
    and the plain solve on them equals the JAX solve."""
    ps, state, ints, floats = random_planes(5, 256, 64, r=4, sc=2, t=2,
                                            sv=8)
    nb = 2
    arrays = {"ints": ps.ints.numpy().reshape(-1, nb, 128),
              "f32s": ps.f32s.numpy().reshape(ps.u, nb, 128),
              "sc_meta": ps.sc_meta.numpy(),
              "planes": state.numpy().reshape(-1, nb, 128),
              "pod_ints": ints.numpy(), "pod_floats": floats.numpy(),
              "num_values": ps.v, "sv": 8}
    ps2, state2, ints2, floats2 = from_reference(arrays, "cpu")
    assert (ps2.r, ps2.sc, ps2.t, ps2.u, ps2.sv) == (4, 2, 2, ps.u, 8)
    assert torch.equal(state2, state)
    want, want_planes = jax_sv_solve(ps, state, ints, floats)
    got = solve_plain(SolverParams(), ps2, state2, ints2, floats2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state2.numpy(), want_planes)


def test_sv_epochs_never_take_the_slot_stream():
    """The slot route declines an ``sv`` epoch at a width where it packs
    one without; the plain slot solve and the slot kernel's wrapper raise
    on one."""
    n, t = 5120, 100
    ps, state, ints, floats = random_planes(6, n, 32, r=4, t=t, sv=8)
    c = ps.r + 4 + 2 * ps.sc
    ints[:, c:c + 3 * t] = 0        # one term reference a pod at most
    ints[:, c] = 1
    floats[:] = 0
    no_sv = ps._replace(sv=0)
    base = ints[:, :c + 3 * t].contiguous()
    assert plan_launch(n, ps.r, ps.sc, t, ps.u).kernel == "wide"
    assert CudaPlanesBackend.slot_route(no_sv, base.numpy(),
                                        floats.numpy()) is not None
    assert CudaPlanesBackend.slot_route(ps, ints.numpy(),
                                        floats.numpy()) is None
    assert plan_launch(n, ps.r, ps.sc, t, ps.u, packs=True,
                       sv=8).kernel == "wide"
    with pytest.raises(ValueError, match="shared-volume"):
        solve_plain_slots(SolverParams(), ps, state, ints, floats)
    with pytest.raises(ValueError, match="shared-volume"):
        solve_kernel.check(ps, state, ints, floats, slots=True)
    with pytest.raises(ValueError, match="shared-volume"):
        solve_kernel.slots_plan(ps)


def test_sv_launch_plan_and_checks():
    """The cluster kernel's shared memory grows by the two pod columns of
    both chunk buffers and nothing else; the wrapper's check wants the
    ``sv`` rows and columns and refuses a slot or column out of range."""
    args = (4, 1, 1, 2, 16, 64, 64, 32)
    assert (cluster_smem_bytes(*args, sv=512) - cluster_smem_bytes(*args)
            == 4 * 2 * 32 * 2)
    assert cluster_smem_bytes(*args, sv=8) == cluster_smem_bytes(*args,
                                                                 sv=512)
    ps, state, ints, floats = random_planes(8, 256, 16, r=4, sv=8)
    solve_kernel.check(ps, state, ints, floats)
    with pytest.raises(ValueError):
        solve_kernel.check(ps, state, ints[:, :-2].contiguous(), floats)
    with pytest.raises(ValueError):
        solve_kernel.check(ps._replace(sv=0), state, ints, floats)
    c = ps.r + 4 + 2 * ps.sc + 3 * ps.t
    bad = ints.clone()
    bad[0, c] = 9
    with pytest.raises(ValueError, match="shared-volume slot"):
        solve_kernel.check(ps, state, bad, floats)
    bad = ints.clone()
    bad[0, c + 1] = ps.r
    with pytest.raises(ValueError, match="attach"):
        solve_mod.check_sv(bad.numpy(), ps.r, ps.sc, ps.t, 8)
