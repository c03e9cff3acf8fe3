"""PyTorch port, the evaluation slice's multi-class half:
`build_postprocess_multi`, `evaluator.detection_stats` and
`build_infer_fn(mode="multi")` against the JAX package, on the scenes,
fabricated outputs and real-network weights of test_torch_port_eval.py,
with JAX's draws handed to the port (per chunk, per class, per image).

Tolerances, with the largest difference measured on this CPU beside them:
  multi fabricated outputs: regression         atol 1e-5 (9.5e-7)
  multi postprocess: valid, cls, n_inliers    equal
                     R / T / score            atol 1e-4 / rtol 1e-3 / atol 1e-5
                                              (7.7e-7, 5.9e-7, 0)
  detection_stats                             equal
  infer(mode="multi"): valid, cls             equal; score atol 1e-5 (5.2e-8)
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from kd6d_pose_adlp_tpu.engine import evaluator as jev
from kd6d_pose_adlp_tpu_torch.engine import evaluator as tev
from kd6d_pose_adlp_tpu_torch.engine.postprocess import build_postprocess_multi

from test_torch_port_eval import (BS, N_FG, _gumbel, _jax_gumbel_fn, _recording,  # noqa: F401
                                  _t_fabricated, env, real_net)
from test_train_e2e import _fabricated_outputs_multi as _j_fabricated_multi


def test_multi_postprocess_and_detection_stats_match_jax(env, real_net, monkeypatch):
    """One compiled JAX multi postprocess serves the three comparisons:
    detection_stats (its outputs recorded), and JAX's multi-mode endpoint,
    run on the eval batch's float images."""
    import kd6d_pose_adlp_tpu.engine.postprocess as jpp
    import kd6d_pose_adlp_tpu.engine.serving as jserving
    from kd6d_pose_adlp_tpu.engine.serving import MULTI_KEYS as J_MULTI_KEYS
    from kd6d_pose_adlp_tpu_torch.engine.serving import MULTI_KEYS, build_infer_fn

    jce, tce = env["jce"], env["tce"]
    jconsts, tconsts = env["jconsts"], env["tconsts"]
    jb, tb = env["jb"][:2], env["tb"][:2]
    # the multi fabricated outputs: the port's equal JAX's, and drive both
    touts = [_t_fabricated(b, tconsts, env["tc"], multi=True) for b, _ in tb]
    jouts = [(jnp.asarray(l.numpy()), jnp.asarray(r.numpy())) for l, r in touts]
    for (l, r), (b, _) in zip(touts, jb):
        jl, jr = _j_fabricated_multi(b, jconsts, env["jc"])
        np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    gfn = _jax_gumbel_fn(2, multi=True)

    jpred = jpp.build_postprocess_multi(jce, jconsts, N_FG)
    jraw = []
    monkeypatch.setattr(jpp, "build_postprocess_multi",
                        lambda *a, **k: _recording(jpred, jraw, np.asarray))
    it = iter(jouts)
    want = jev.detection_stats(jce, jconsts, None, lambda v, im: next(it), iter(jb),
                               n_fg=N_FG, verbose=False)
    tpred = build_postprocess_multi(tce, tconsts, N_FG)
    traw = []
    it2 = iter(touts)
    got = tev.detection_stats(tce, tconsts, lambda im: next(it2), iter(tb), n_fg=N_FG,
                              gumbel_fn=gfn, verbose=False)
    assert got == want and got["recovery_rate"] > 0
    for i, ((b, _), (tl, tr)) in enumerate(zip(tb, touts)):
        g = {k: v.numpy() for k, v in tpred(tl, tr, b.bbox_trans, gumbel=gfn(i)).items()}
        w = jraw[i]
        assert g["valid"].shape == (BS, N_FG) and g["valid"].any()
        for k in ("valid", "cls", "n_inliers"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)
        v = w["valid"]
        np.testing.assert_allclose(g["R"][v], w["R"][v], atol=1e-4)
        np.testing.assert_allclose(g["T"][v], w["T"][v], rtol=1e-3)

    # the multi-mode serving endpoint on the real network's weights
    jnet, variables, _, net = real_net
    assert MULTI_KEYS == J_MULTI_KEYS
    monkeypatch.setattr(jserving, "build_postprocess_multi", lambda *a, **k: jpred)
    b = jb[0][0]
    j_infer = jserving.build_infer_fn(jce, jconsts, variables, mode="multi")
    want = jax.device_get(j_infer(jnp.asarray(b.images), jnp.asarray(b.bbox_trans),
                                  jnp.asarray(b.class_ids[:, 0]), jnp.asarray(7, jnp.uint32)))
    draws = torch.from_numpy(np.stack([_gumbel(kc, BS) for kc in jax.random.split(
        jax.random.PRNGKey(7), N_FG)]))
    t_infer = build_infer_fn(tce, tconsts, net, mode="multi", device="cpu")
    got = t_infer(tb[0][0].images, tb[0][0].bbox_trans, tb[0][0].class_ids[:, 0],
                  gumbel=draws)
    assert list(got) == list(MULTI_KEYS) and got["valid"].shape == (BS, N_FG)
    for k in ("valid", "cls"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want["valid"].all()
    np.testing.assert_allclose(got["score"].numpy(), want["score"], atol=1e-5)
    R = got["R"].numpy()
    assert np.isfinite(R).all()
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-4)


