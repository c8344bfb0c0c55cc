"""The port's coupling analysis (``repro_torch.core.coupling``, paper §3.5)
against the JAX package's.

On identical Jacobi, value-iteration and SCF problems (``device="cpu"``
on the port's side) ``coupling_density`` and ``block_internal_coupling``
give the reference's numbers (tolerance 0.0: both are means of the same
integer counts) and ``predict_acceleration_survives`` the same verdict,
among them the paper's two extremes: Jacobi's sparse stencil
(acceleration does not survive staleness) and the dense SCF map (it
does).
"""

import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.problems as jp  # noqa: E402
from repro.core import async_engine as j_async_engine  # noqa: E402
from repro.core import coupling as j_coupling  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import async_engine, coupling  # noqa: E402

JAX = dict(core=jcore, probs=jp, device={})
PORT = dict(core=tcore, probs=tp, device=dict(device="cpu"))

PROBLEMS = {
    "jacobi_g16": lambda p: p["probs"].JacobiProblem(
        grid=16, sweeps=5, seed=0, **p["device"]),
    "jacobi_g40": lambda p: p["probs"].JacobiProblem(
        grid=40, sweeps=5, seed=1, **p["device"]),
    "vi_garnet": lambda p: p["probs"].ValueIterationProblem(
        p["probs"].GarnetMDP(S=60, A=4, b=5, gamma=0.9, seed=0,
                             **p["device"])),
    "vi_gridworld": lambda p: p["probs"].ValueIterationProblem(
        p["probs"].GridWorldMDP(g=6, **p["device"])),
    "scf_ppp8": lambda p: p["probs"].SCFProblem(
        p["probs"].PPPChain(8, 2.0, 1.0, **p["device"])),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_coupling_density_matches_reference(name):
    t, j = PROBLEMS[name](PORT), PROBLEMS[name](JAX)
    assert tcore.coupling_density(t) == jcore.coupling_density(j)
    assert tcore.predict_acceleration_survives(t) == \
        jcore.predict_acceleration_survives(j)
    for thr in (0.001, 0.1, 0.9):
        assert tcore.predict_acceleration_survives(t, thr) == \
            jcore.predict_acceleration_survives(j, thr)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("p", [1, 2, 4])
def test_block_internal_coupling_matches_reference(name, p):
    t, j = PROBLEMS[name](PORT), PROBLEMS[name](JAX)
    tb, jb = t.default_blocks(p), j.default_blocks(p)
    assert [b.tolist() for b in tb] == [b.tolist() for b in jb]
    got = tcore.block_internal_coupling(t, tb)
    assert got == jcore.block_internal_coupling(j, jb)
    assert 0.0 < got <= 1.0


def test_the_papers_two_extremes():
    """Jacobi sits near 5/n (acceleration is corrupted by staleness);
    the dense SCF map at 1 (it survives)."""
    jac = PROBLEMS["jacobi_g40"](PORT)
    assert tcore.coupling_density(jac) < 0.01
    assert not tcore.predict_acceleration_survives(jac)
    scf = PROBLEMS["scf_ppp8"](PORT)
    assert tcore.coupling_density(scf) == 1.0
    assert tcore.predict_acceleration_survives(scf)


def test_module_exports_and_shim():
    for name in coupling.__all__:
        assert getattr(tcore, name) is getattr(coupling, name)
    assert set(coupling.__all__) == set(j_coupling.__all__)
    assert set(async_engine.__all__) == set(j_async_engine.__all__)
    assert async_engine.run_fixed_point is tcore.run_fixed_point
