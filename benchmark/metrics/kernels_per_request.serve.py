"""kernels_per_request.serve: device kernels a request launches, from the
device-only profiled stretch's trace. Moves serve_images_per_s."""
UNIT = "count"


def read(run):
    tr = run.layer.get("trace")
    if run.layer.get("kind") != "serve" or not tr:
        return None
    return tr["kernels"] / run.layer["traced_requests"]
