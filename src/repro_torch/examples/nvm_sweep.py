"""Design-space exploration: sweep cache capacity x memory technology and
print the full scalability picture (paper §4.3), plus the TPU cross-layer
verdicts for any dry-run results present.  Runs on the CUDA device unless
told otherwise:

    PYTHONPATH=src python -m repro_torch.examples.nvm_sweep [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from repro_torch.core.crosslayer import analyze_dryrun_dir
from repro_torch.core.scaling import ppa_scaling, workload_scaling
from repro_torch.device import DeviceLike, resolve_device

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"


def report(device: DeviceLike = None, results: Path = RESULTS) -> List[str]:
    """The sweep's printout: PPA scaling, workload-normalized EDP, and the
    verdicts of the dry-run records under ``results`` if there are any."""
    dev = resolve_device(device)
    out = ["=== PPA scaling (paper Fig 10) ==="]
    cfgs = ppa_scaling(device=dev)
    out.append(f"{'cap':>4} | " + " | ".join(f"{m:^22}" for m in cfgs))
    out.append(f"{'MB':>4} | "
               + " | ".join(f"{'rd-ns  wr-ns  mm2':^22}" for _ in cfgs))
    for c in sorted(next(iter(cfgs.values()))):
        row = " | ".join(
            f"{cfgs[m][c].read_latency_ns:6.2f} "
            f"{cfgs[m][c].write_latency_ns:6.2f}"
            f" {cfgs[m][c].area_mm2:7.2f}" for m in cfgs)
        out.append(f"{c:4.0f} | {row}")

    out.append("\n=== workload-normalized EDP vs SRAM (paper Figs 11-13) "
               "===")
    res = workload_scaling(device=dev)
    out.append(f"{'cap':>4} | {'STT total':>10} {'STT edp':>9} | "
               f"{'SOT total':>10} {'SOT edp':>9}")
    for c in sorted(res):
        r = res[c]
        out.append(f"{c:4.0f} | {r['STT']['total']['mean']:10.3f} "
                   f"{r['STT']['edp']['mean']:9.3f} | "
                   f"{r['SOT']['total']['mean']:10.3f} "
                   f"{r['SOT']['edp']['mean']:9.3f}")

    if results.exists() and list(results.glob("*.json")):
        cells = []
        for tag in ("final", "baseline"):
            try:
                cells = analyze_dryrun_dir(str(results), tag=tag,
                                           device=dev)
                break
            except FileNotFoundError:
                continue  # no records under this tag; try the next
        out.append(f"\n=== TPU cross-layer verdicts ({len(cells)} dry-run "
                   f"cells) ===")
        for v in cells[:12]:
            out.append(f"  {v.arch:24s} {v.shape:12s} {v.mesh:8s} "
                       f"EDP STT {v.edp_ratio['STT']:.2f}  "
                       f"SOT {v.edp_ratio['SOT']:.2f}")
    else:
        out.append("\n(no dry-run results yet: run `python -m "
                   "repro.launch.dryrun`)")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(report(args.device)))


if __name__ == "__main__":
    main()
