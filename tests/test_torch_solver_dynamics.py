"""The GPU solver's dynamics and end-boundary targets against the JAX
package and the port's native oracle, on the CPU: the float32 propagator and
table interpolation, the float32 target (the tangent of the RK4 map) and
the float64 target (the variational equations).  The shooting kernels'
own checks against these plain versions run on the card
(``tests/test_torch_solver_kernels.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rdm_tpu.ops import df32 as jdf
from rdm_tpu.physics import cr3bp as jcr3bp
from rdm_tpu.physics import dynamics_df as jddf
from rdm_tpu.physics import manifold as jmanifold
from rdm_tpu_torch import native
from rdm_tpu_torch.physics import cr3bp, dynamics_f64, halo, manifold

torch.set_num_threads(1)  # the suite runs in parallel worker processes

# (alpha, tau, length, tolerance) of tests/test_manifold.py: the float32
# target's own error against float64, which grows with energy and arc
# length.  Two float32 evaluations (the JAX package's autodiff tangent and
# the port's dual numbers round the tangent differently, 3e-7 apart after
# the halo phase) each lie within it.
CASES = [(0.02, 0.25, 6.0, 1e-3), (0.05, 0.6, 8.0, 3e-2), (0.09, 0.9, 10.5, 3e-2)]


def f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def f64(x):
    return torch.tensor(np.asarray(x, np.float64))


def test_propagate_matches_jax():
    """A constant-control arc of 64 RK4 steps in float32, four states: the
    same float32 operations in the same order as ``cr3bp.propagate`` (the
    harness caps XLA's ISA, so neither side fuses), so equal to 1e-6 of
    max(1, |s|) (the mass runs to 750)."""
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-0.5, 0.5, (4, 6)), rng.uniform(400, 750, (4, 1))], 1)
    u = rng.normal(size=(4, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    thr = rng.uniform(0, 1, 4)
    theirs = np.asarray(jax.vmap(lambda s, uu, t: jcr3bp.propagate(s, uu, t, 1.0, 0.5, 64))(
        jnp.asarray(s0, jnp.float32), jnp.asarray(u, jnp.float32), jnp.asarray(thr, jnp.float32)))
    ours = cr3bp.propagate(f32(s0), f32(u), f32(thr), 1.0, 0.5, 64).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * np.abs(theirs).max())
    assert ours.dtype == np.float32


@pytest.mark.parametrize("alpha", [0.0, 0.01, 0.047, 0.09, 0.2])
def test_interp_seed_matches_jax(alpha):
    """The float32 table interpolation of ``jnp.interp`` (clamped at the
    table's ends): the eigenvector within one float32 rounding of the norm."""
    s, p, v = jmanifold.interp_seed_jnp(jnp.float32(alpha))
    s2, p2, v2 = manifold.interp_seed(torch.tensor([alpha], dtype=torch.float32))
    np.testing.assert_array_equal(s2.numpy()[0], np.asarray(s))
    assert float(p2[0]) == float(p)
    np.testing.assert_allclose(v2.numpy()[0], np.asarray(v), rtol=0, atol=6e-8)


@pytest.mark.parametrize("alpha,tau,length,tol", CASES)
def test_f32_target_matches_jax(alpha, tau, length, tol):
    ours = manifold.manifold_target(f32([alpha]), f32([tau]), f32([length])).numpy()[0]
    theirs = np.asarray(jmanifold.manifold_target(jnp.float32(alpha), jnp.float32(tau),
                                                  jnp.float32(length)))
    assert np.isfinite(ours).all()
    assert np.abs(ours - theirs).max() < tol, (ours, theirs)


def test_tangent_transport_matches_jax_jvp():
    """256 halo steps of the state and its tangent: the tangent is the jvp
    of the discrete RK4 map on both sides; the state bit for bit, the
    tangent within 1e-6 (autodiff and dual numbers order the derivative's
    products differently)."""
    s, p, v = jmanifold.interp_seed_jnp(jnp.float32(0.05))
    tau = jnp.float32(0.6) * p
    x1, v1 = jmanifold.propagate_with_tangent(s, v, tau, 256)
    x2, v2 = manifold.propagate_with_tangent(f32(s)[None], f32(v)[None], f32([tau]), 256)
    np.testing.assert_allclose(x2.numpy()[0], np.asarray(x1), rtol=0, atol=1e-7)
    np.testing.assert_allclose(v2.numpy()[0], np.asarray(v1), rtol=0, atol=1e-6)


@pytest.mark.parametrize("alpha,tau,length", [c[:3] for c in CASES])
def test_f64_target_matches_df32_and_native(alpha, tau, length):
    """The float64 target against the JAX package's double-float32 one
    (read back exactly with ``df32.to_f64``) and against the port's C++
    oracle.  Both sides transport the tangent with the variational
    equations.  The df32 twin takes the eigenvector in float32 (so both
    are given it so) and normalises the transported direction in float32
    (``dynamics_df.py:236-240``): its seed moves by up to MANIFOLD_EPS x
    2^-24 ~ 6e-12, which the backward arc amplifies by up to ~1e5, hence
    1e-6.  The C++ oracle computes in float64 like the port, to 1e-10 (the
    arc's amplification of a few roundings)."""
    sd = halo.interp_seed(alpha)
    vs32 = np.asarray(sd["vstable"], np.float32).astype(np.float64)

    def ours(vs):
        return dynamics_f64.manifold_target_from_data(
            f64(sd["state0"])[None], f64([sd["period"]]), f64(vs)[None], f64([tau]),
            f64([length])).numpy()[0]

    df = jdf.to_f64(jddf.manifold_target_from_data_df(
        jdf.const(sd["state0"]), jdf.const(float(sd["period"])), jnp.asarray(vs32, jnp.float32),
        jdf.const(tau), jdf.const(length)))
    np.testing.assert_allclose(ours(vs32), df, rtol=0, atol=1e-6)
    nat = native.manifold_target(sd["state0"], float(sd["period"]), sd["vstable"], tau, length)
    np.testing.assert_allclose(ours(sd["vstable"]), nat, rtol=0, atol=1e-10)


def test_variational_field_is_the_jacobian_of_the_field():
    """``_ode12``'s tangent part is the ballistic field's Jacobian times the
    tangent: against central differences of ``ode6`` in float64."""
    rng = np.random.default_rng(3)
    s = f64(np.concatenate([rng.uniform(0.7, 0.95, (3, 1)), rng.uniform(-0.1, 0.1, (3, 5))], 1))
    d = f64(rng.normal(size=(3, 6)))
    out = dynamics_f64._ode12(torch.cat([s, d], -1))
    h = 1e-6
    fd = (dynamics_f64.ode6(s + h * d) - dynamics_f64.ode6(s - h * d)) / (2 * h)
    np.testing.assert_allclose(out[:, :6].numpy(), dynamics_f64.ode6(s).numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(out[:, 6:].numpy(), fd.numpy(), rtol=1e-7, atol=1e-7)


def test_manifold_target_batch_on_the_cpu():
    """The batched entry point: float32 targets of [N] triples through the
    kernel's wrapper, which on the CPU runs the plain version."""
    out = manifold.manifold_target_batch([0.02, 0.05], [0.25, 0.6], [6.0, 8.0], device="cpu")
    assert out.shape == (2, 6) and out.dtype == torch.float32
    for i, (alpha, tau, length, _) in enumerate(CASES[:2]):
        single = manifold.manifold_target(f32([alpha]), f32([tau]), f32([length]))[0]
        np.testing.assert_array_equal(out[i].numpy(), single.numpy())
