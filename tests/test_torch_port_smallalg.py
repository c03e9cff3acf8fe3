"""PyTorch port, small linear algebra and EPnP (`kd6d_pose_adlp_tpu_torch/
ops/smallalg.py`, `ops/epnp.py`) against the JAX package on the same seeded
numpy inputs. The port keeps the JAX algorithms (not torch.linalg), so the
same fixed inits, sweep and iteration counts give the same null spaces.

Tolerances, with the largest difference measured on this CPU beside them:
  inv3 / inv4 / solve_spd                     rtol 1e-4  (max rel 8.4e-7)
  solve3                                      rtol 1e-4  (max rel 1.5e-6)
  eigh3 / eigh4 values, vectors               atol 1e-4  (max 2.2e-5, 1.4e-5)
  smallest_eigvecs values, span projector     atol 1e-5, 1e-3 (max 1.1e-7, 1.8e-7)
  rotation_horn, and R R^T = I                atol 1e-5  (max 6.0e-7)
  epnp, exact data, vs ground truth           0.05 deg / 0.5 mm (1.0e-4 deg, 2.5e-4 mm)
                    vs JAX                    0.05 deg / 0.5 mm (1.2e-4 deg, 3.1e-4 mm)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.ops import epnp as jep
from kd6d_pose_adlp_tpu.ops import smallalg as jsa
from kd6d_pose_adlp_tpu.utils import geometry as geo
from kd6d_pose_adlp_tpu_torch.ops import epnp as tep
from kd6d_pose_adlp_tpu_torch.ops import smallalg as tsa

K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]],
             np.float32)
t = torch.from_numpy


def _rot_deg(Ra, Rb):
    """Angle between two rotations from the chord |Ra - Rb|_F = 2 sqrt(2)
    sin(angle / 2): stable near 0, where arccos of the fp32 trace floors at
    a few hundredths of a degree."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def _spd(rng, n, batch):
    A = rng.normal(size=(batch, n, n)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)


# ---------------------------------------------------------------------------
# smallalg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4])
def test_inverses_match_jax(n):
    A = _spd(np.random.default_rng(n), n, 16)
    jf, tf = (jsa.inv3, tsa.inv3) if n == 3 else (jsa.inv4, tsa.inv4)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(A)))
    np.testing.assert_allclose(tf(t(A)).numpy(), want, rtol=1e-4, atol=1e-6)
    b = np.random.default_rng(9).normal(size=(16, n)).astype(np.float32)
    np.testing.assert_allclose(
        tsa.solve_spd(t(A), t(b), n).numpy(),
        np.asarray(jax.vmap(functools.partial(jsa.solve_spd, n=n))(
            jnp.asarray(A), jnp.asarray(b))), rtol=1e-4, atol=1e-5)
    if n == 3:
        np.testing.assert_allclose(
            tsa.solve3(t(A), t(b)).numpy(),
            np.asarray(jax.vmap(jsa.solve3)(jnp.asarray(A), jnp.asarray(b))),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [3, 4])
def test_symmetric_eigh_matches_jax(n):
    S = _spd(np.random.default_rng(10 + n), n, 16)
    jf, tf = (jsa.eigh3, tsa.eigh3) if n == 3 else (jsa.eigh4, tsa.eigh4)
    jw, jv = jax.jit(jax.vmap(jf))(jnp.asarray(S))
    tw, tv = tf(t(S))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_smallest_eigvecs_match_jax():
    """The 12x12 null space of EPnP: same fixed init, same 8 iterations,
    same Rayleigh-Ritz step. Compared as the projector onto the span."""
    rng = np.random.default_rng(4)
    B = rng.normal(size=(8, 12, 12)).astype(np.float32)
    lam = np.concatenate([[1e-4, 3e-4, 1e-3, 3e-3], np.linspace(1, 5, 8)])
    Q = np.linalg.qr(B)[0]
    A = (Q * lam[None, None, :].astype(np.float32)) @ Q.transpose(0, 2, 1)
    A = A.astype(np.float32)
    jw, jv = jax.jit(jax.vmap(jsa.smallest_eigvecs))(jnp.asarray(A))
    tw, tv = tsa.smallest_eigvecs(t(A))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    Pj = np.asarray(jv) @ np.asarray(jv).transpose(0, 2, 1)
    Pt = (tv @ tv.transpose(-1, -2)).numpy()
    np.testing.assert_allclose(Pt, Pj, atol=1e-3)
    np.testing.assert_array_equal(tsa._subspace_init(12, 4), jsa._subspace_init(12, 4))


def test_rotation_horn_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(16, 20, 3)).astype(np.float32)
    X -= X.mean(1, keepdims=True)
    R = np.stack([geo.quaternion2rotation(rng.normal(size=4)) for _ in range(16)]
                 ).astype(np.float32)
    Y = X @ R.transpose(0, 2, 1) + rng.normal(scale=0.01, size=X.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (16, 20)).astype(np.float32)
    want = np.asarray(jax.vmap(jsa.rotation_horn)(jnp.asarray(X), jnp.asarray(Y),
                                                   jnp.asarray(w)))
    got = tsa.rotation_horn(t(X), t(Y), t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


# ---------------------------------------------------------------------------
# EPnP / RANSAC
# ---------------------------------------------------------------------------

def _scene(rng, n=24, noise=0.0):
    R = geo.quaternion2rotation(rng.normal(size=4)).astype(np.float32)
    T = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60),
                  rng.uniform(600, 1100)], np.float32)
    pts3d = rng.uniform(-60, 60, size=(n, 3)).astype(np.float32)
    pts2d = geo.project_points(K, R, T, pts3d).astype(np.float32)
    pts2d += rng.normal(scale=noise, size=pts2d.shape).astype(np.float32)
    return R, T, pts3d, pts2d


def test_epnp_exact_correspondences():
    rng = np.random.default_rng(0)
    scenes = [_scene(rng) for _ in range(4)]
    P3 = np.stack([s[2] for s in scenes])
    P2 = np.stack([s[3] for s in scenes])
    w = np.ones(P3.shape[:2], np.float32)
    R, T = tep.epnp(t(P3), t(P2), t(K), t(w))
    Rj, Tj = jax.jit(jax.vmap(lambda a, b, c: jep.epnp(a, b, jnp.asarray(K), c)))(
        jnp.asarray(P3), jnp.asarray(P2), jnp.asarray(w))
    for i, (Rg, Tg, _, _) in enumerate(scenes):
        assert _rot_deg(Rg, R[i].numpy()) < 0.05
        assert np.linalg.norm(Tg - T[i].numpy()) < 0.5
        assert _rot_deg(np.asarray(Rj[i]), R[i].numpy()) < 0.05
        assert np.linalg.norm(np.asarray(Tj[i]) - T[i].numpy()) < 0.5
