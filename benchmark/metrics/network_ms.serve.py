"""network_ms.serve: milliseconds of the endpoint's network a request, its
own span (`infer(..., timings=)["network_s"]`, a synchronize after it),
the mean over the traced run's timed window. Moves serve_images_per_s."""
import statistics

UNIT = "ms"


def read(run):
    spans = run.layer.get("network_s")
    return 1e3 * statistics.fmean(spans) if spans else None
