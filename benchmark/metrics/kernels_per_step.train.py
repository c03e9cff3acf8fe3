"""kernels_per_step.train: device kernels a training step launches, from
the device-only profiled stretch's trace. Moves train_images_per_s."""
UNIT = "count"


def read(run):
    tr = run.layer.get("trace")
    if run.layer.get("kind") != "train" or not tr:
        return None
    return tr["kernels"] / run.layer["traced_steps"]
