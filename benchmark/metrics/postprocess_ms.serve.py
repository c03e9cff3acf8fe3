"""postprocess_ms.serve: milliseconds of the endpoint's postprocess a
request (voting, RANSAC-EPnP, LHM), its own span (`timings
["postprocess_s"]`), the mean over the traced run's timed window. Moves
serve_images_per_s."""
import statistics

UNIT = "ms"


def read(run):
    spans = run.layer.get("postprocess_s")
    return 1e3 * statistics.fmean(spans) if spans else None
