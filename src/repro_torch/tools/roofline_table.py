"""The roofline table of the dry-run records (torch counterpart of
``tools/roofline_table.py``), over ``build/dryrun/``:

    PYTHONPATH=src python -m repro_torch.tools.roofline_table [tag] \\
        [--mesh 16x16] [--dir build/dryrun]

One row per ``*__{tag}.json`` record: the compute, memory and collective
terms, the dominant one, model flops over counted flops (MF/count), the
roofline fraction, the collectives by kind, the per-device argument
bytes and the seconds the trace took.  The terms are times MODELED at the
TPU tier's constants (``launch/roofline.py``: 197 TFLOP/s bf16, 819 GB/s
HBM, 50 GB/s a link), not measurements of any device.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.roofline import PEAK_FLOPS


def rows(results_dir=RESULTS_DIR, tag: str = "baseline", mesh=None):
    """The table's rows, one per record, in file-name order."""
    out = []
    for p in sorted(Path(results_dir).glob(f"*__{tag}.json")):
        r = json.loads(p.read_text())
        if mesh and r["mesh"] != mesh:
            continue
        roof = r["roofline"]
        bound = max(roof["compute_s"], roof["memory_s"],
                    roof["collective_s"])
        mf = r["model_flops_per_device"]
        out.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "compute_ms": roof["compute_s"] * 1e3,
            "memory_ms": roof["memory_s"] * 1e3,
            "collective_ms": roof["collective_s"] * 1e3,
            "dominant": roof["dominant"],
            "mf_ratio": r.get("model_flops_ratio") or 0.0,
            "roofline_frac": mf / PEAK_FLOPS / bound if bound else 0.0,
            "collectives": roof.get("collective_counts") or {},
            "arg_gib": r["memory"]["argument_bytes"] / 2**30,
            "trace_s": r.get("trace_s"),
        })
    return out


def fmt(tag: str = "baseline", mesh=None, results_dir=RESULTS_DIR) -> str:
    hdr = ("| arch | shape | mesh | compute ms | memory ms | collective ms "
           "| dominant | MF/count | roofline frac | collectives "
           "| args GiB/dev | trace s |")
    out = [hdr, "|" + "---|" * 12]
    for r in rows(results_dir, tag, mesh):
        coll = " ".join(f"{k} {v}" for k, v in sorted(r["collectives"].items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_ms']:.1f} | {r['memory_ms']:.1f} | "
            f"{r['collective_ms']:.1f} | {r['dominant']} | "
            f"{r['mf_ratio']:.2f} | {r['roofline_frac']:.3f} | {coll} | "
            f"{r['arg_gib']:.2f} | {r['trace_s']:.1f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tag", nargs="?", default="baseline")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    print(fmt(args.tag, args.mesh, args.dir))


if __name__ == "__main__":
    main()
