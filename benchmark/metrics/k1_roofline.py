"""k1_roofline: kernel K1's share of its roofline, in %: the least time
of the K1 solves the device-only profiled stretch launched
(`roofline.k1_bound` at each launch's P x T, N = batch x 8 keypoints, the
KD schedule's eps count) over the device time of the kernels whose name
holds `k1_`. Moves train_images_per_s."""
import tracing
from reference.sinkhorn import epsilon_schedule
from roofline import k1_bound

UNIT = "%"


def read(run):
    lay = run.layer
    prob, tr = lay.get("k1_problem"), lay.get("trace")
    if not prob or not tr or not lay.get("k1_launches"):
        return None
    kd = prob["kd"]
    n_eps = len(epsilon_schedule(kd["p"], 2.0, kd["blur"], kd["scaling"]))
    bound = 0.0
    for key, count in lay["k1_launches"].items():
        P, T = (int(v) for v in key.rsplit(":", 1)[1].split("x"))
        bound += count * k1_bound(prob["N"], P, T, n_eps)
    n, secs = tracing.kernel_seconds(tr, "k1_")
    return 100.0 * bound / secs if n and secs > 0 else None
