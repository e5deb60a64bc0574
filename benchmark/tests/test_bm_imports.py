"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name."""

import ast
import os
import subprocess
import sys

from benchmark import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_names():
    mods = ["metaasr_tpu_torch", "metaasr_tpu_torch.task", "jaxtyping",
            "numpy", "flaxen", "metaasr_tpu_extra"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax.numpy", "metaasr_tpu.ops",
                                         "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "metaasr_tpu.ops"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_yardstick_and_reference_read_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for f in os.listdir(os.path.join(HERE, sub)):
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in
                        _imports(os.path.join(HERE, sub, f))}
                assert not tops & {"metaasr_tpu_torch", "metaasr_tpu", "jax",
                                   "jaxlib", "flax"}, (sub, f)


def test_a_run_loads_no_jax():
    """Import every module a run of each job kind loads, the program's
    included, in a fresh process, and look at sys.modules."""
    code = (
        "import sys, glob, os\n"
        "from benchmark import run, calibrate, faults, sweep, training\n"
        "from benchmark.reference import beam_score, training as t2\n"
        "from benchmark.yardstick import readers, trace, load\n"
        "for kind in ('meta_train', 'mono_train', 'serve', 'meta_train_dp'):\n"
        "    run.load_module(f'{run.HERE}/jobs/{kind}.py', kind)\n"
        "for f in glob.glob(f'{run.HERE}/metrics/*.py'):\n"
        "    run.load_module(f, os.path.basename(f)[:-3])\n"
        "import metaasr_tpu_torch.train.meta_train\n"
        "import metaasr_tpu_torch.train.mono\n"
        "import metaasr_tpu_torch.serve.export\n"
        "import metaasr_tpu_torch.serve.batcher\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
