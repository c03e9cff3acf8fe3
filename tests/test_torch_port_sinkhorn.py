"""PyTorch port, Sinkhorn OT (`kd6d_pose_adlp_tpu_torch/ops/sinkhorn.py`,
`ops/sinkhorn_fused.py`) against `kd6d_pose_adlp_tpu/ops/sinkhorn.py` and
the Pallas kernel K1 (`ops/sinkhorn_pallas._solve_potentials`, run in
interpret mode as the JAX package's own tests run it).

Inputs: 16 random problems of 64 + 64 points in [0, 1]², weights in
[0.1, 1] with the tail zeroed as padding (the KD loss's shape per image
and keypoint); the potentials also at the edge shapes that chip_smoke.py
checks the CUDA kernel at (N, P, T) = (3, 1, 1), (5, 1, 128), (3, 128, 128)
and (7, 64, 37). Tolerances, with the largest difference measured on this
CPU beside them:
  K1 plain potentials vs JAX interpret     rtol 2e-4, atol 1e-6  (max abs 7.2e-7)
    and per potential, over its real and its padded points apart,
    max|diff| <= 2e-4 * max|JAX| there                   (max ratio 5.7e-5)
  divergence vs the JAX default path       rtol 2e-4, atol 2e-5  (max abs 3.8e-6)
  d/da, d/db elementwise                   rtol 1e-4, atol 1e-6
  d/dx, d/dy by direction                  cosine >= 0.99, norm ratio within 5%
  kernel losses (energy ... l2)            rtol 1e-5, atol 1e-6
(JAX's own Pallas-vs-XLA test uses rtol 2e-4, atol 2e-5.) At blur 1e-3 the
transport plan is nearly one-hot, so float-noise differences in the
potentials move near-tied assignments: point gradients are compared by
direction, as in `tests/test_sinkhorn_pallas.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.ops import sinkhorn as jsk
from kd6d_pose_adlp_tpu.ops.sinkhorn_pallas import _solve_potentials
from kd6d_pose_adlp_tpu_torch.ops import sinkhorn as tsk
from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused as sf
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(p=2.0, blur=1e-3, scaling=0.5, diameter=2.0)


@pytest.fixture(autouse=True)
def pinned_float_state():
    """The float state an earlier file in the same xdist worker could have
    left, pinned for every test: torch at one intra-op thread (the
    imported `one_torch_thread`), denormals kept (torch's default) and JAX
    in float32 at its default matmul precision."""
    torch.set_flush_denormal(False)
    assert not jax.config.jax_enable_x64
    assert jax.config.jax_default_matmul_precision is None
    yield


def _clouds(seed, N=16, P=64, T=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (N, P, 2)).astype(np.float32)
    y = rng.uniform(0, 1, (N, T, 2)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, (N, P)).astype(np.float32)
    b = rng.uniform(0.1, 1.0, (N, T)).astype(np.float32)
    a[:, max(1, 3 * P // 4):] = 0.0      # a one-point cloud keeps its point
    b[:, max(1, 5 * T // 8):] = 0.0
    return x, y, a, b


def _t(*arrays):
    return [torch.from_numpy(np.array(v)) for v in arrays]


def _assert_potentials_close(name, got, want, mask, ratio):
    """max|got - want| <= ratio * max|want| over the real (mask) and the
    padded points apart. At the last eps (1e-6) the self potentials a_x, b_y
    are ~1e-6 at real points but ~1e-2 at padded ones, so an absolute
    tolerance over all points cannot see a wrong real-point value."""
    d = np.abs(got.astype(np.float64) - want)
    for grp, sel in (("real", mask), ("padded", ~mask)):
        if sel.any():   # a one-point cloud has no padded points
            assert d[sel].max() <= ratio * np.abs(want[sel]).max(), (name, grp)


# the KD loss's shape in three forms, then the shapes at which chip_smoke.py
# holds the CUDA kernel against this plain version: one point, one point
# against the 128-point cap, the cap, and P != T
@pytest.mark.parametrize("shape,reach,debias", [
    pytest.param((16, 64, 64), 0.5, True, id="0.5-True"),
    pytest.param((16, 64, 64), None, True, id="None-True"),
    pytest.param((16, 64, 64), 0.5, False, id="0.5-False"),
    pytest.param((3, 1, 1), 0.5, True, id="N3-P1-T1"),
    pytest.param((5, 1, 128), 0.5, True, id="N5-P1-T128"),
    pytest.param((3, 128, 128), 0.5, True, id="N3-P128-T128"),
    pytest.param((7, 64, 37), None, True, id="N7-P64-T37-balanced"),
])
def test_plain_potentials_match_the_pallas_kernel(shape, reach, debias):
    x, y, a, b = _clouds(0, *shape)
    al = np.asarray(jsk._safe_log_weights(jnp.asarray(a)))
    bl = np.asarray(jsk._safe_log_weights(jnp.asarray(b)))
    want = _solve_potentials(*map(jnp.asarray, (x, y, al, bl)), reach=reach,
                             debias=debias, interpret=True, **KW)
    got = sf.solve_potentials(*_t(x, y, al, bl), reach=reach, debias=debias, **KW)
    for name, g, w, m in zip(("a_x", "b_y", "a_y", "b_x"), got, want, (a, b, b, a)):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
        _assert_potentials_close(name, g.numpy(), np.asarray(w, np.float64), m > 0, 2e-4)


def test_schedule_and_padding_semantics():
    """12 eps values at the KD defaults; a row whose columns are all padded
    gives -eps * (-1e30 + log T) through the max-subtract, as in JAX."""
    eps, lams = tsk.schedule(2.0, 1e-3, 0.5, 0.5, 2.0)
    assert len(eps) == 12 and eps[0] == 4.0 and abs(eps[-1] - 1e-6) < 1e-18
    assert lams[0] == 1.0 / (1.0 + 4.0 / 0.25)
    C = torch.zeros((1, 2, 3))
    h = torch.full((1, 3), -1e30)
    got = tsk._softmin(0.5, C, h)
    want = jsk._softmin(0.5, jnp.zeros((2, 3)), jnp.full((3,), -1e30))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6)
    assert np.isclose(float(got[0, 0]), -0.5 * (-1e30 + np.log(3.0)), rtol=1e-6)


def test_plain_solve_rejects_bad_inputs():
    x, y, a, b = _t(*_clouds(1, N=2, P=8, T=8))
    with pytest.raises(ValueError):
        sf.solve_potentials(x, y[:1], a, b)
    with pytest.raises(TypeError):
        sf.solve_potentials(x.double(), y, a, b)
    # the Sinkhorn loss is told which solve to use; it has no default
    with pytest.raises(ValueError):
        tsk.samples_loss(x, y, a, b, gtype="sinkhorn")


@pytest.mark.parametrize("reach", [None, 0.5])
@pytest.mark.parametrize("debias", [True, False])
def test_divergence_matches_the_jax_default_path(reach, debias):
    x, y, a, b = _clouds(2)
    want = jax.vmap(lambda *t: jsk.sinkhorn_divergence(*t, reach=reach, debias=debias,
                                                       **KW))(*map(jnp.asarray, (x, y, a, b)))
    got = tsk.sinkhorn_divergence(*_t(x, y, a, b), reach=reach, debias=debias,
                                  solve=sf.solve_potentials, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    if reach == 0.5 and debias:
        # batched_samples_loss over (B, 8) leading axes, as the KD loss calls it
        shp = lambda v: v.reshape((2, 8) + v.shape[1:])
        bl = jsk.batched_samples_loss(*(jnp.asarray(shp(v)) for v in (x, y, a, b)),
                                      gtype="sinkhorn", **KW)
        tl = tsk.batched_samples_loss(*_t(*(shp(v) for v in (x, y, a, b))),
                                      gtype="sinkhorn", solve=sf.solve_potentials, **KW)
        assert tl.shape == (2, 8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(bl), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("reach", [None, 0.5])
def test_gradients_match_the_jax_default_path(reach):
    x, y, a, b = _clouds(3, N=4)

    def jloss(x_, y_, a_, b_):
        return jsk.batched_samples_loss(x_, y_, a_, b_, gtype="sinkhorn",
                                        reach=reach, **KW).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, y, a, b)))
    tx, ty, ta, tb = _t(x, y, a, b)
    for t in (tx, ty, ta, tb):
        t.requires_grad_(True)
    tsk.batched_samples_loss(tx, ty, ta, tb, gtype="sinkhorn", reach=reach,
                             solve=sf.solve_potentials, **KW).sum().backward()
    for name, g, w in (("a", ta.grad, jg[2]), ("b", tb.grad, jg[3])):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    for name, g, w in (("x", tx.grad, jg[0]), ("y", ty.grad, jg[1])):
        g, w = g.numpy().reshape(-1), np.asarray(w).reshape(-1)
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w) + 1e-12)
        assert cos >= 0.99, (name, cos)
        assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) < 0.05, name
    # padded points get exactly zero weight gradient through the log
    assert torch.isfinite(ta.grad[:, 48:]).all()


@pytest.mark.parametrize("gtype", ["energy", "gaussian", "laplacian", "l1", "l2"])
def test_kernel_losses_match(gtype):
    x, y, a, b = _clouds(4, N=4, P=16, T=24)
    want = jsk.batched_samples_loss(*map(jnp.asarray, (x, y, a, b)), gtype=gtype,
                                    blur=0.5)
    ga = jax.grad(lambda a_: jsk.batched_samples_loss(
        jnp.asarray(x), jnp.asarray(y), a_, jnp.asarray(b), gtype=gtype,
        blur=0.5).sum())(jnp.asarray(a))
    tx, ty, ta, tb = _t(x, y, a, b)
    ta.requires_grad_(True)
    got = tsk.batched_samples_loss(tx, ty, ta, tb, gtype=gtype, blur=0.5)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mutation", [None, "a_x zero", "a_x zero at real points",
                                      "b_y doubled", "a_x 1e-3 high"])
def test_chip_smoke_potential_check_sees_a_wrong_self_potential(mutation):
    """chip_smoke's K1 check (per potential, real and padded points apart,
    max|kernel - plain| <= 1e-5 max|plain|) passes the plain solve against
    itself and flags each wrong self potential below. An absolute tolerance
    of 1e-5 over all points would pass every one of them at real points,
    where a_x and b_y are ~1e-6."""
    import chip_smoke

    x, y, a, b = _t(*_clouds(5))
    args = (x, y, tsk._safe_log_weights(a), tsk._safe_log_weights(b))
    want = sf.solve_potentials_plain(*args, reach=0.5, debias=True, **KW)
    a_x, b_y, a_y, b_x = (t.clone() for t in want)
    if mutation == "a_x zero":
        a_x = torch.zeros_like(a_x)
    elif mutation == "a_x zero at real points":
        a_x = torch.where(a > 0, torch.zeros_like(a_x), a_x)
        assert (a_x - want[0]).abs().max() < 1e-5
    elif mutation == "b_y doubled":
        b_y = 2 * b_y
    elif mutation == "a_x 1e-3 high":
        a_x = a_x * (1 + 1e-3)
    pots = chip_smoke.potential_errors((a_x, b_y, a_y, b_x), want, a, b)
    assert chip_smoke.potentials_agree(pots) == (mutation is None), pots
