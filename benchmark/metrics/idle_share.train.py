"""idle_share.train: the share of the device-only profiled stretch of the
traced run (whole calls of the window's training call) in which no device
operation ran, in %: 100 (1 - busy / window). Moves train_images_per_s."""
UNIT = "%"


def read(run):
    tr = run.layer.get("trace")
    if run.layer.get("kind") != "train" or not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
