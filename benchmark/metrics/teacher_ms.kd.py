"""teacher_ms.kd: milliseconds of the teacher's forward and votes
(`engine/steps.teacher_votes`) on one pool batch alone, between CUDA
events, the mean over the pool's batches, after the traced run's window.
Only a distilling cell has a teacher. Moves train_images_per_s."""
UNIT = "ms"


def read(run):
    return run.layer.get("teacher_ms")
