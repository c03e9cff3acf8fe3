"""What a run loads: no module whose top-level name is `jax`, `jaxlib`,
`flax` or `kd6d_pose_adlp_tpu` (compared whole: the program's own name
begins with the JAX package's), and the reference alone loads nothing of
the program. Each in a fresh interpreter."""
import os
import subprocess
import sys

from conftest import BENCH, HERE

ROOT = os.path.dirname(BENCH)


def run_py(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, BENCH, HERE]))
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_each_cell_s_run_loads_no_jax():
    out = run_py(
        "import sys, harness\n"
        "from conftest import run_small\n"
        "for name in harness.workload_names():\n"
        "    rc, result, err = run_small(name)\n"
        "    assert rc == 0 and result['correct'], err\n"
        "    assert harness.forbidden_modules() == [], harness.forbidden_modules()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = eval(out.strip().splitlines()[-1])
    assert "kd6d_pose_adlp_tpu_torch" in top
    assert not {"jax", "jaxlib", "flax", "kd6d_pose_adlp_tpu"} & set(top)


def test_the_reference_loads_nothing_of_the_program():
    out = run_py(
        "import sys, pkgutil, importlib, reference\n"
        "for m in pkgutil.iter_modules(reference.__path__):\n"
        "    importlib.import_module('reference.' + m.name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    top = eval(out.strip().splitlines()[-1])
    assert "reference" in top
    assert not {"kd6d_pose_adlp_tpu_torch", "jax", "jaxlib", "flax",
                "kd6d_pose_adlp_tpu"} & set(top)
