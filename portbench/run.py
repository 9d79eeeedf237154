"""Run one cell of ``BENCHMARK.json`` once and print one JSON result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (each read by ``metrics/<name>.py``) with the device's
busy and window seconds and a ``breakdown``.  Every run checks what the
timed path produced against the float32 reference and prints the numbers
compared, each beside its limit, as its last lines on standard error and
under ``checks`` in the result.  It needs a CUDA card: without one, or
with fewer than the cell asks for, it exits non-zero and prints no
result.  The port's kernel builds stay in ``build/`` of this checkout."""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse                                   # noqa: E402
import importlib.util                             # noqa: E402
import json                                       # noqa: E402
import os                                         # noqa: E402
import sys                                        # noqa: E402
from pathlib import Path                          # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (from /proc where there is
    one, else since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names compared: ``repro_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its nvcc libraries into ``build/repro_torch`` itself)."""
    base = ROOT / "build" / "portbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))


class Ctx:
    """What a driver gets: the resolved cell, its shapes, the seed, the
    window, the device, and the harness's hooks."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, plant=None, age=process_age):
        from portbench.cell import architecture
        self.cell = cell
        self.arch = architecture(cell["config"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self._plant = plant
        self._age = age

    def plant(self, obj) -> None:
        """A test's hook on the system under test (none in a real run)."""
        if self._plant is not None:
            self._plant(obj)

    def since_start(self) -> float:
        return self._age()

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        import gc
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def memory_peak(self) -> int:
        import torch
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def profiler(self):
        from portbench.tracing import Profiler
        return Profiler()


def load_reader(name: str):
    path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(checks: dict) -> bool:
    """``correct``: every number compared at or under its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             plant=None, age=process_age) -> dict:
    """Drive the cell once and judge it: the result line's fields."""
    from portbench import serve, train
    import torch
    from portbench.reference.numerics import strict_f32
    driver = {"serve": serve, "train": train}[cell["workload"]["kind"]]
    ctx = Ctx(cell, seed, seconds, trace, device, plant, age)
    out = driver.run(ctx)
    units = {m["name"]: m["unit"] for m in cell["end_to_end"]
             + cell["per_layer"]}
    metrics = {}
    breakdown = None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        pl = out.pop("per_layer")
        for m in cell["per_layer"]:
            v = load_reader(m["name"])(pl)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = pl["trace"]
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps()}
    else:
        for name, v in out.pop("end_to_end").items():
            if name in units:
                metrics[name] = {"value": v, "unit": units[name]}
    strict_f32()
    checks = driver.check(ctx, out)
    correct = judge(checks)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    from portbench.cell import manifest, resolve
    cell = resolve(args.workload, manifest())
    import torch
    need = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark may not load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
