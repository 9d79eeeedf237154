"""What the harness loads: never JAX nor the JAX package (whole top-level
names: ``repro_torch`` starts with ``repro``), and a reference that loads
nothing of the program.  Without a card, or without the program beside
it, ``run.py`` exits non-zero and prints no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


def _py(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_run_imports_no_jax_nor_the_jax_package():
    code = (
        "import sys, glob, importlib.util\n"
        "import portbench.run as r\n"
        "from portbench import serve, train, control, tracing\n"
        "from portbench.cell import port_config\n"
        "import repro_torch.models, repro_torch.serve, repro_torch.train.trainer\n"
        "import repro_torch.optim, repro_torch.data\n"
        "for f in sorted(glob.glob('portbench/metrics/*.py')):\n"
        "    s = importlib.util.spec_from_file_location('m', f)\n"
        "    importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "print(r.forbidden_modules())\n")
    out = _py(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_names():
    code = ("import sys, types\n"
            "import portbench.run as r\n"
            "sys.modules['repro_torch_extra'] = types.ModuleType('x')\n"
            "a = r.forbidden_modules()\n"
            "sys.modules['repro.core'] = types.ModuleType('y')\n"
            "print(a, r.forbidden_modules())\n")
    out = _py(code)
    assert out.stdout.strip() == "[] ['repro']", out.stderr[-2000:]


def test_reference_loads_nothing_of_the_program():
    for f in sorted((PB / "reference").glob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (f, n)
    code = ("import sys\n"
            "import portbench.reference.decoder, portbench.reference.train\n"
            "import portbench.reference.data, portbench.reference.numerics\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax')))\n")
    out = _py(code)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen2-7b.train.s2048", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen2-7b.train.s2048", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
