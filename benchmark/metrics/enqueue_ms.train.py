"""enqueue_ms.train: host milliseconds a step spends in the training call
before it returns, with no sync (the host's pace while the launch queue
has room; where the queue is full it waits for the device), over the
traced run's timed window. Moves train_images_per_s."""
UNIT = "ms"


def read(run):
    lay = run.layer
    if lay.get("kind") != "train" or "enqueue_s_per_step" not in lay:
        return None
    return 1e3 * lay["enqueue_s_per_step"]
