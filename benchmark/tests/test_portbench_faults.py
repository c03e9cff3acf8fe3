"""A run with the timed path broken underneath must come out not correct:
a step that returns its state unchanged, half of the batch left out (the
mean taken over the rest), a call of k steps that feeds each step its
first slot and draws, an answer altered where it is produced. (One chip a
cell: there is no exchange between chips to leave out.)"""
import pytest
import torch

from conftest import run_small

TRAIN = ["kd_train.tiny_h_d53.b16", "train.darknet53.b16"]
SERVE = "serve.tiny_h.multi_b32"


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch):
    from kd6d_pose_adlp_tpu_torch.engine import steps

    def update(self, params, grads, state):
        return state, torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    monkeypatch.setattr(steps.AdamW, "update", update)
    rc, result, err = run_small(name)
    assert rc == 0, err
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    from kd6d_pose_adlp_tpu_torch.engine import steps
    real = steps.pose_losses

    def half(cls_logits, pred_reg, batch, consts, cfg, teacher=None, uniform=None, **kw):
        h = cls_logits.shape[0] // 2
        if teacher is not None:
            votes, w, hh = teacher
            teacher = (type(votes)(*(t[:h] for t in votes)), w, hh)
        out = real(cls_logits[:h], pred_reg[:h], batch.take(slice(0, h)), consts, cfg,
                   teacher=teacher, uniform=None if uniform is None else uniform[:h], **kw)
        return out._replace(loss_cls=2 * out.loss_cls, loss_reg=2 * out.loss_reg)

    monkeypatch.setattr(steps, "pose_losses", half)
    rc, result, err = run_small(name)
    assert rc == 0, err
    assert not result["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_call_feeds_each_step_its_first_slot(name, monkeypatch):
    from kd6d_pose_adlp_tpu_torch.engine import steps
    real = steps.build_multi_step

    def build(*a, **kw):
        multi = real(*a, **kw)

        def frozen(state, teacher_arg, pool, start, k, generator=None, uniforms=None):
            losses = []
            for _ in range(k):
                state, m = multi(state, teacher_arg, pool, start, 1, generator,
                                 None if uniforms is None else uniforms[:1])
                losses.append(m["loss_total"])
            return state, dict(m, loss_total=torch.stack(losses).mean())

        return frozen

    monkeypatch.setattr(steps, "build_multi_step", build)
    rc, result, err = run_small(name, steps_per_call=4)   # 3 of the call's 4 steps fed wrong
    assert rc == 0, err
    assert not result["correct"]
    failed = {n for n, c in result["checks"].items() if c["value"] > c["limit"]}
    assert failed & {"call_loss_gap", "change_gap"}, result["checks"]


def _broken_postprocess(monkeypatch, alter):
    from kd6d_pose_adlp_tpu_torch.engine import serving
    real = serving.build_postprocess_multi

    def build(*a, **kw):
        predict = real(*a, **kw)
        return lambda *pa, **pkw: alter(predict(*pa, **pkw))

    monkeypatch.setattr(serving, "build_postprocess_multi", build)


def test_serving_half_the_batch_left_out(monkeypatch):
    def half(out):
        h = out["R"].shape[0] // 2
        return {k: torch.cat([v[:h], v[:h]])[:v.shape[0]] for k, v in out.items()}

    _broken_postprocess(monkeypatch, half)
    rc, result, err = run_small(SERVE)
    assert rc == 0, err
    assert not result["correct"]


def test_serving_an_answer_altered(monkeypatch):
    def alter(out):
        """One crop's answer (its pose for every class) moved sideways by
        half its depth: 1 answer of the request's B."""
        out = dict(out)
        out["T"] = out["T"].clone()
        out["T"][0, :, 0] += 0.5 * out["T"][0, :, 2].abs()
        return out

    _broken_postprocess(monkeypatch, alter)
    rc, result, err = run_small(SERVE)
    assert rc == 0, err
    assert not result["correct"]
