"""The benchmark's own tests: its files, its arithmetic, the reference
against the program at a small size on the CPU, the check failing on the
faults a cell can have, and (on a CUDA card) the control.

Tests marked `card` need a CUDA card; whether there is one is decided in
the `card` fixture, when a test runs. Run them on the card with
`python -m pytest benchmark/tests -m card`."""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [os.path.dirname(BENCH), BENCH]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


def small_cell(name: str, **traffic) -> dict:
    """A cell of the benchmark cut to a size the CPU runs in seconds: 64²
    crops (darknet53 without P6/P7, so that its coarsest stride fits), two
    images a batch, a pool of three, two steps a call, 16 RANSAC
    hypotheses over 8 votes a class, two LHM steps; `traffic` overrides
    keys of the traffic file after that."""
    import harness
    cell = copy.deepcopy(harness.load_cell(name))
    raw = cell["config_raw"]
    for which in ("student", "teacher"):
        if which in raw:
            raw[which]["model"]["input_res"] = 64
            if raw[which]["model"]["backbone"] == "darknet53":
                raw[which]["model"]["use_higher_levels"] = False
    raw["test"].update(ransac_iters=16, max_votes=8, lhm_iters=2)
    t = cell["traffic_raw"]
    t.update(batch=2, pool=3)
    if t["kind"] == "train_pool":
        t["steps_per_call"] = 2
    else:
        t["sample_requests"] = 2
    t.update(traffic)
    return cell


def run_small(name: str, seed: int = 3000000001, device="cpu", trace: int = 0, **traffic):
    """One run of a small cell on `device`: (exit code, result dict or
    None, standard error)."""
    import io
    import json

    import harness
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", name, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], device=device, cell=small_cell(name, **traffic),
                      out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
