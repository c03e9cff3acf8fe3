"""k2_roofline: kernel K2's share of its roofline, in %: the least time of
the K2 launches the device-only profiled stretch made (`roofline.k2_bound`
at each launch's shape: the eval stem's C -> O at the input's side, the
second stage's at half of it) over the device time of the kernels whose
name holds `conv3x3_`. Moves serve_images_per_s."""
import tracing
from roofline import k2_bound

UNIT = "%"
# the eval-mode stem segment's two convolutions: (C, O) -> the side of
# their input as a share of the image's
SIDES = {(3, 8): 1, (8, 16): 2}


def read(run):
    lay = run.layer
    tr, launches = lay.get("trace"), lay.get("k2_launches")
    if not tr or not launches:
        return None
    bound = 0.0
    for key, count in launches.items():
        _, co, dtype = key.split(":")
        C, O = (int(v) for v in co.split("x"))
        if (C, O) not in SIDES or dtype not in ("float32", "bfloat16"):
            return None
        side = lay["res"] // SIDES[(C, O)]
        bound += count * k2_bound(lay["batch"], C, O, side, side,
                                  elem=4 if dtype == "float32" else 2)
    n, secs = tracing.kernel_seconds(tr, "conv3x3_")
    return 100.0 * bound / secs if n and secs > 0 else None
