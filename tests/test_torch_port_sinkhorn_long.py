"""PyTorch port, K1's solve (`kd6d_pose_adlp_tpu_torch/ops/sinkhorn_fused.py`)
on the problems past its first kernel's old limits, against the JAX
package: an eps schedule longer than 64 steps (74 at `--scaling 0.9`, blur
1e-3) and clouds past 128 points. On the CPU the wrapper runs its plain
version, which is what the CUDA kernel is held to on the card
(chip_smoke.py's K1_WIDE shapes); these tests hold that plain version to
JAX.

Inputs: seeded numpy clouds in [0, 1]², weights in [0.1, 1] with a tail
zeroed as padding (`test_torch_port_sinkhorn._clouds`). The references,
with the tolerances and the largest differences measured on this CPU:
  potentials, 74 eps, N=8 P=T=64     the Pallas kernel's body
                                     (`sinkhorn_pallas._make_kernel`)
    each potential over all its points, and over its real and its
    padded points apart: max|port - JAX| <= 1e-5 * max|JAX| there
                                                     (max ratio 2.4e-7)
  potentials, N=8 P=200 T=130        `_solve_potentials(interpret=True)`
    each potential over all its points: <= 1e-5 * max|JAX|   (2.9e-7)
    over its real and its padded points apart: <= 2e-4 * max|JAX| there,
    test_torch_port_sinkhorn's bound (9.7e-5, at a_x's real points, which
    are ~1.2e-6: XLA sums the 200-column rows in another order than
    PyTorch, and the self potentials at real points keep ~1e-4 of that
    float32 noise; the other potentials and groups <= 2.9e-7)
  potentials, N=4 P=200 T=130,        `_solve_potentials(interpret=True)`
  without debias and reach
    a_x, b_y: zero in both; a_y, b_x over all their points: <= 1e-5 *
    max|JAX|, and over their real and padded points apart <= 2e-4 *
    max|JAX| there                                   (max ratio 3.1e-7)
  divergence, N=4 P=300 T=200, 74 eps   `ops/sinkhorn.sinkhorn_divergence`
                                     (vmapped, eager): rtol 1e-5 (max 3.1e-7)
  its gradients in a, b              ||port - JAX|| <= 1e-5 ||JAX|| (1.4e-7)
  its gradients in x, y              ||port - JAX|| <= 3e-3 ||JAX|| (9.7e-4;
    8.0e-4 to 1.05e-3 over seeds 1-9 and 12): they weigh each pair by its
    plan entry exp((f_i + g_j - C_ij) / eps), so at eps = 1e-6 the
    potentials' float32 differences (<= 3e-7 of their largest value)
    enter the exponents a million times over
  kd_ot_loss at scaling 0.9          `engine/losses.kd_ot_loss`: rtol 1e-5
                                     (max 1.7e-7)
The 74-step Pallas program is not compiled here: its interpret-mode
compile took ~95 s on one core of this CPU, more than this file's budget,
so its body runs eagerly on arrays standing in for its refs (the same
float32 operations, one at a time); the 12-step comparison at 200 x 130
points goes through `_solve_potentials(interpret=True)` itself. JAX's
divergence and KD loss run eagerly too, so no 74-step loop is compiled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kd6d_pose_adlp_tpu.engine import losses as jl
from kd6d_pose_adlp_tpu.ops import sinkhorn as jsk
from kd6d_pose_adlp_tpu.ops.sinkhorn_pallas import _make_kernel, _solve_potentials
from kd6d_pose_adlp_tpu_torch.engine import losses as tl
from kd6d_pose_adlp_tpu_torch.ops import sinkhorn as tsk
from kd6d_pose_adlp_tpu_torch.ops import sinkhorn_fused as sf
from test_torch_port_losses import _cfgs, _student, _targets, _votes
from test_torch_port_pool import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_sinkhorn import (_assert_potentials_close, _clouds,  # noqa: F401
                                      pinned_float_state)

KW = dict(p=2.0, blur=1e-3, diameter=2.0)
LONG = 0.9          # --scaling: 74 eps steps at blur 1e-3
RATIO = 1e-5
SPLIT_RATIO = 2e-4  # real and padded points apart, at 200 x 130 (docstring)
POINT_GRAD_RATIO = 3e-3  # the x and y gradients (docstring)
NAMES = ("a_x", "b_y", "a_y", "b_x")


class _Ref:
    """An array standing in for a Pallas ref: `r[...]` reads it, `r[...] = v`
    writes it."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, index):
        return self.value

    def __setitem__(self, index, value):
        self.value = value


def _log_weights(a, b):
    return (np.array(jsk._safe_log_weights(jnp.asarray(a))),
            np.array(jsk._safe_log_weights(jnp.asarray(b))))


def _assert_potential_close(name, got, want, mask, split_ratio):
    """max|got - want| <= RATIO * max|want| over all the potential's points,
    and <= split_ratio * max|want| over its real (mask) and its padded
    points apart."""
    assert np.abs(got.astype(np.float64) - want).max() <= RATIO * np.abs(want).max(), name
    _assert_potentials_close(name, got, want, mask, split_ratio)


def _port_potentials(x, y, al, bl, scaling):
    got = sf.solve_potentials(*(torch.from_numpy(v) for v in (x, y, al, bl)),
                              scaling=scaling, reach=0.5, debias=True, **KW)
    return [g.numpy() for g in got]


@pytest.fixture(scope="module")
def long_schedule():
    """The port's and the Pallas kernel body's potentials at 74 eps steps."""
    x, y, a, b = _clouds(10, N=8, P=64, T=64)
    al, bl = _log_weights(a, b)
    eps_list = jsk.epsilon_schedule(KW["p"], KW["diameter"], KW["blur"], LONG)
    assert len(eps_list) == 74 == len(tsk.schedule(KW["p"], KW["blur"], LONG, 0.5,
                                                   KW["diameter"])[0])
    refs = [_Ref() for _ in NAMES]
    _make_kernel(eps_list, 0.5 ** KW["p"], KW["p"], True)(
        *(_Ref(jnp.asarray(v)) for v in (x, y, al, bl)), *refs)
    want = [np.asarray(r.value, np.float64) for r in refs]
    return _port_potentials(x, y, al, bl, LONG), want, (a, b, b, a)


@pytest.mark.parametrize("k", range(4), ids=NAMES)
def test_potentials_on_a_74_step_schedule_match_the_pallas_kernel(long_schedule, k):
    got, want, masks = long_schedule
    _assert_potential_close(NAMES[k], got[k], want[k], masks[k] > 0, RATIO)


@pytest.fixture(scope="module")
def wide_clouds():
    """The port's and `_solve_potentials(interpret=True)`'s potentials at
    P = 200, T = 130 on the default 12-step schedule."""
    x, y, a, b = _clouds(11, N=8, P=200, T=130)
    al, bl = _log_weights(a, b)
    want = _solve_potentials(*map(jnp.asarray, (x, y, al, bl)), scaling=0.5, reach=0.5,
                             debias=True, interpret=True, **KW)
    return (_port_potentials(x, y, al, bl, 0.5), [np.asarray(w, np.float64) for w in want],
            (a, b, b, a))


@pytest.mark.parametrize("k", range(4), ids=NAMES)
def test_potentials_at_200_by_130_points_match_the_pallas_kernel(wide_clouds, k):
    got, want, masks = wide_clouds
    _assert_potential_close(NAMES[k], got[k], want[k], masks[k] > 0, SPLIT_RATIO)


@pytest.fixture(scope="module")
def wide_clouds_unbalanced():
    """The port's and `_solve_potentials(interpret=True)`'s potentials at
    N = 4, P = 200, T = 130 without debias and without reach (the two passes
    of the balanced, biased form, which the CUDA kernel's cluster route runs
    past 128 points on rows of every shift)."""
    x, y, a, b = _clouds(16, N=4, P=200, T=130)
    al, bl = _log_weights(a, b)
    kw = dict(KW, scaling=0.5, reach=None, debias=False)
    want = _solve_potentials(*map(jnp.asarray, (x, y, al, bl)), interpret=True, **kw)
    got = sf.solve_potentials(*(torch.from_numpy(v) for v in (x, y, al, bl)), **kw)
    return ([g.numpy() for g in got], [np.asarray(w, np.float64) for w in want],
            (a, b, b, a))


@pytest.mark.parametrize("k", range(4), ids=NAMES)
def test_unbalanced_potentials_without_debias_at_200_by_130_match_the_pallas_kernel(
        wide_clouds_unbalanced, k):
    got, want, masks = wide_clouds_unbalanced
    if k < 2:   # a_x and b_y: zero without debias, in both
        assert not got[k].any() and not want[k].any()
    _assert_potential_close(NAMES[k], got[k], want[k], masks[k] > 0, SPLIT_RATIO)


@pytest.fixture(scope="module")
def long_divergence():
    """JAX's and the port's divergences at N=4, P=300, T=200, 74 eps, with
    their gradients in (x, y, a, b)."""
    x, y, a, b = _clouds(12, N=4, P=300, T=200)
    jfn = jax.vmap(lambda *u: jsk.sinkhorn_divergence(*u, scaling=LONG, reach=0.5, **KW))
    jval, vjp = jax.vjp(jfn, *map(jnp.asarray, (x, y, a, b)))
    jgrad = vjp(jnp.ones_like(jval))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, y, a, b)]
    tval = tsk.sinkhorn_divergence(*ts, solve=sf.solve_potentials, scaling=LONG, reach=0.5,
                                   **KW)
    tval.sum().backward()
    return (tval.detach().numpy(), [t.grad.numpy() for t in ts], np.asarray(jval),
            [np.asarray(g) for g in jgrad])


def test_divergence_on_a_74_step_schedule_matches_jax(long_divergence):
    tval, _, jval, _ = long_divergence
    assert tval.shape == (4,) and np.all(np.abs(jval) > 0)
    np.testing.assert_allclose(tval, jval, rtol=RATIO, atol=0)


@pytest.mark.parametrize("k", range(4), ids=("x", "y", "a", "b"))
def test_divergence_gradients_on_a_74_step_schedule_match_jax(long_divergence, k):
    _, tgrad, _, jgrad = long_divergence
    g, w = tgrad[k].astype(np.float64), jgrad[k].astype(np.float64)
    assert np.isfinite(g).all() and np.linalg.norm(w) > 0
    ratio = POINT_GRAD_RATIO if k < 2 else RATIO
    assert np.linalg.norm(g - w) <= ratio * np.linalg.norm(w)


def test_kd_ot_loss_on_a_74_step_schedule_matches_jax():
    jcf, tcf = _cfgs(scaling=LONG)
    assert len(tsk.schedule(tcf.kd.p, tcf.kd.blur, tcf.kd.scaling, tcf.kd.reach,
                            2.0)[0]) == 74
    jt, tt = _targets(13)
    jv, tv = _votes(14)
    logits, pred_xy = _student(15)
    want = float(jl.kd_ot_loss(jnp.asarray(logits), jnp.asarray(pred_xy), jt, jv, jcf))
    got = float(tl.kd_ot_loss(torch.from_numpy(logits), torch.from_numpy(pred_xy), tt, tv,
                              tcf))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RATIO, atol=0)
