"""The port's train launcher and the ``train_lm`` example on the CPU: runs,
checkpoints and resumes (plain, fused and with EF-int8 gradient
compression).  These are the slowest CPU tests of the training stack; a
file of their own lets ``pytest --dist loadfile`` give them a worker of
their own.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import (effective_optimizer,  # noqa: E402
                                       init_state)


# --- launcher ----------------------------------------------------------------


def test_launcher_runs_then_resumes_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--reduced", "--steps", "8",
            "--steps-per-sync", "4", "--ckpt-dir", str(tmp_path)]
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert run.returncode == 0, run.stderr
    assert "step    8 loss" in run.stdout
    assert "checkpoints [8]" in run.stdout
    assert launch_train.main(args[:4] + ["12"] + args[5:]) == 0
    out = capsys.readouterr().out
    assert "restored step 8" in out and "done @12" in out
    assert launch_train.main(args[:4] + ["14", "--no-fused"]
                             + args[5:]) == 0
    assert "done @14" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [12, 14]


def test_launcher_compresses_gradients_on_cpu(tmp_path, capsys):
    """``launch.train --reduced --compress-grads --compress-shards 2``:
    falling window means, a verdict line and a resume from its compressed
    checkpoint, fused and per-step."""
    import re
    args = ["--device", "cpu", "--reduced", "--steps", "8",
            "--steps-per-sync", "4", "--compress-grads", "--compress-shards",
            "2", "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(args) == 0
    out = capsys.readouterr().out
    means = [float(m) for m in re.findall(r"window mean (\S+)\)", out)]
    assert len(means) == 2 and means[1] < means[0], out
    assert "train_window_b8_s128_k4: energy vs SRAM STT" in out
    assert launch_train.main(args[:4] + ["12", "--no-fused"]
                             + args[5:]) == 0
    out = capsys.readouterr().out
    assert "restored step 8" in out and "done @12" in out
    like = init_state(build_model(reduced(get_config("llama3-8b"),
                                          num_layers=4, d_model=128,
                                          d_ff=256), max_seq=128,
                                  device="cpu"),
                      effective_optimizer(AdamW(lr=constant(1e-3)), True, 2),
                      torch.Generator().manual_seed(1))
    state = CheckpointManager(str(tmp_path)).restore(like)
    assert int(state["step"]) == 12
    assert all(e.shape[0] == 2 and bool(torch.isfinite(e).all())
               for e in state["opt"]["err"].values())


def test_train_lm_example_runs_then_resumes_on_cpu(tmp_path):
    """``repro_torch.examples.train_lm --device cpu``: fused windows, a
    checkpoint, the verdict line; then a resume past it, per-step."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    args = ["--device", "cpu", "--steps", "8", "--steps-per-sync", "4",
            "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)]
    cmd = [sys.executable, "-m", "repro_torch.examples.train_lm"]
    run = subprocess.run(cmd + args, capture_output=True, text=True,
                         timeout=300, cwd=root, env=env)
    assert run.returncode == 0, run.stderr
    assert "step    8  loss" in run.stdout and "fused K=4" in run.stdout
    assert "energy vs SRAM STT" in run.stdout
    assert "checkpoints: [4, 8]" in run.stdout
    run = subprocess.run(cmd + args[:2] + ["--steps", "12", "--no-fused"]
                         + args[4:], capture_output=True, text=True,
                         timeout=300, cwd=root, env=env)
    assert run.returncode == 0, run.stderr
    assert "resumed from checkpoint at step 8" in run.stdout
    assert "final loss" in run.stdout and "checkpoints: [8, 12]" in \
        run.stdout
