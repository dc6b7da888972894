"""What the benchmark loads, and how ``run.py`` refuses to run (CPU)."""
import glob
import json
import os
import shutil
import subprocess
import sys

from portbench import bench

ROOT = bench.ROOT
SRC = os.path.join(ROOT, "src")
HERE = bench.HERE


def _python(code, cwd=ROOT, path=(ROOT, SRC)):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    readers = sorted(glob.glob(os.path.join(HERE, "e2e", "*.py")) + glob.glob(os.path.join(HERE, "layers", "*.py")))
    code = f"""
import importlib, json, os, runpy, sys
sys.argv = ["run.py"]
runpy.run_path({os.path.join(HERE, 'run.py')!r}, run_name="portbench_run")
import portbench.bench as B, portbench.traffic, portbench.trace, portbench.sweep
import repro_torch.serving.planner
for name in ("resnet50", "vgg16"):
    importlib.import_module("portbench.reference." + name); importlib.import_module("portbench.counts." + name)
for path in {readers!r}:
    kind, name = path.split(os.sep)[-2], os.path.basename(path)[:-3]
    B.load_reader(kind, name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = set(_python(code))
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in top and "portbench" in top


def test_the_references_load_nothing_of_the_program():
    code = """
import json, sys
import portbench.reference.resnet50, portbench.reference.vgg16
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    top = set(_python(code))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _run(cwd):
    cell = bench.load_spec()["workloads"][0]["name"]
    cmd = [sys.executable, "portbench/run.py", "--workload", cell,
           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not out.stdout.strip()


def test_without_the_program_run_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
