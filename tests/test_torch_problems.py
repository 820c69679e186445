"""The seeded plane problems the kernel checks use
(``harness/problems.py::random_planes``) are ones the JAX package solves
the same way as the port's plain solve: against the Pallas kernel in
interpret mode at a narrow constraint space, and against the planes scan
at a wide one, on the assignments and on the final state planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import pallas_solver as jps
from kubernetes_tpu.ops.solver import SolverParams as JaxParams
from kubernetes_tpu_torch.harness.problems import random_planes
from kubernetes_tpu_torch.ops.planes import state_planes
from kubernetes_tpu_torch.ops.solve import solve_plain
from kubernetes_tpu_torch.ops.solver import SolverParams


def jax_solve(backend, ps, state, ints, floats):
    nb = ps.ints.shape[1] // 128
    pstatic = jps.PStatic(
        ints=jnp.asarray(ps.ints.numpy().reshape(-1, nb, 128)),
        f32s=jnp.asarray(ps.f32s.numpy().reshape(ps.u, nb, 128)),
        sc_meta=jnp.asarray(ps.sc_meta.numpy()),
        r=ps.r, sc=ps.sc, t=ps.t, u=ps.u, v=ps.v, nb=nb)
    pstate = jps.PState(planes=jnp.asarray(state.numpy().reshape(-1, nb, 128)))
    got, new = backend.solve(JaxParams(), pstatic, pstate, ints.numpy(),
                             floats.numpy())
    return np.asarray(got), np.asarray(new.planes).reshape(state.shape)


@pytest.mark.parametrize("seed,n,b,width,backend", [
    (0, 256, 48, 2, jps.PallasBackend(interpret=True)),
    (1, 384, 64, 3, jps.XlaPlanesBackend()),
    (2, 256, 64, 12, jps.XlaPlanesBackend()),
])
def test_random_planes_plain_matches_jax(seed, n, b, width, backend):
    ps, state, ints, floats = random_planes(
        seed, n, b, sc=width, t=width, u=min(width, 4), real=n - 40)
    want, want_planes = jax_solve(backend, ps, state, ints, floats)
    got = solve_plain(SolverParams(), ps, state, ints, floats)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), want_planes)
    placed = got[ints[:, ps.r + 3] > 0]
    assert (placed >= 0).sum() > b // 2 and (got == -1).any()
    assert int(got.max()) < n - 40          # padding columns never chosen


def test_random_planes_layout_is_consistent():
    ps, state, ints, floats = random_planes(7, 256, 32, sc=3, t=4, u=2)
    do, cd = state_planes(ps.r, ps.sc, ps.t)
    assert state.shape == (cd, 256) and ints.shape == (32, ps.r + 4 + 18)
    assert floats.shape == (32, 4) and ps.f32s.shape == (2, 256)
    # one count per domain: equal codes hold equal counts
    codes = ps.ints[ps.r + 1 + ps.u]
    counts = state[do["sc_counts"]]
    for code in torch.unique(codes).tolist():
        assert len(torch.unique(counts[codes == code])) == 1
    assert int(ints[:, ps.r + 2].max()) < ps.u
