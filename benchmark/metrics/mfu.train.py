"""mfu.train: the training step's share of the chip's peak, in %: the
step's convolution FLOPs counted from shapes (`flops.train_step_flops`:
the teacher's forward, the student's forward and its backward as twice
the forward, nothing recomputed) x the steps of the traced run's timed
window / its seconds, over the compute dtype's peak (fp32: 3xTF32,
`roofline.CONV_PEAK`). Moves train_images_per_s."""
from roofline import CONV_PEAK

UNIT = "%"


def read(run):
    lay = run.layer
    if lay.get("kind") != "train" or not lay.get("timed_s"):
        return None
    return 100.0 * lay["flops_per_step"] * lay["steps"] / lay["timed_s"] / CONV_PEAK[lay["dtype"]]
