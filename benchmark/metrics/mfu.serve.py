"""mfu.serve: the served network's share of the chip's peak, in %: its
convolution FLOPs a request counted from shapes (`flops.forward_flops`) x
the requests answered in the traced run's timed window / its seconds, over
the compute dtype's peak (`roofline.CONV_PEAK`). Moves serve_images_per_s."""
from roofline import CONV_PEAK

UNIT = "%"


def read(run):
    lay = run.layer
    if lay.get("kind") != "serve" or not lay.get("timed_s"):
        return None
    return (100.0 * lay["flops_per_request"] * lay["requests"] / lay["timed_s"]
            / CONV_PEAK[lay["dtype"]])
