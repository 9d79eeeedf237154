"""Quickstart: the DeepNVM++ pipeline end to end.

Characterize bitcells -> EDAP-tune caches -> profile a workload -> get the
NVM-vs-SRAM verdict -> size the iso-area NVM caches.  Runs on the CUDA
device unless told otherwise:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.core import TABLE1, tune
from repro_torch.core.energy import evaluate, relative
from repro_torch.core.iso import iso_area_capacities
from repro_torch.core.profiles import profile
from repro_torch.device import DeviceLike, resolve_device


def run(device: DeviceLike = None) -> Dict:
    """The five steps' results: tuned 3 MB configs, the ResNet-18
    training profile, each NVM's relative metrics, iso-area capacities."""
    dev = resolve_device(device)
    cfgs = {m: tune(m, 3, device=dev) for m in TABLE1}
    p = profile("ResNet-18", "training", 64, device=dev)
    base = evaluate(p, cfgs["SRAM"])
    verdict = {m: relative(base, evaluate(p, cfgs[m])) for m in ("STT", "SOT")}
    return {"cfgs": cfgs, "profile": p, "verdict": verdict,
            "iso_area": iso_area_capacities(device=dev)}


def report(res: Dict) -> List[str]:
    """The quickstart's printout of ``run``'s results."""
    out = ["=== 1. circuit-level bitcells (paper Table 1) ==="]
    for name, cell in TABLE1.items():
        out.append(f"  {name:5s} sense {cell.sense_latency_ps:5.0f}ps  "
                   f"write {cell.write_latency_ps:7.0f}ps  "
                   f"area {cell.area_rel_sram:.2f}x SRAM")
    out.append("\n=== 2. EDAP-optimal 3MB caches (paper Table 2 / "
               "Algorithm 1) ===")
    for m, p in res["cfgs"].items():
        out.append(
            f"  {m:5s} read {p.read_latency_ns:4.2f}ns/"
            f"{p.read_energy_nj:.2f}nJ  write {p.write_latency_ns:5.2f}ns/"
            f"{p.write_energy_nj:.2f}nJ  leak {p.leakage_mw:5.0f}mW  "
            f"area {p.area_mm2:.2f}mm^2  [banks={p.banks} rows={p.rows} "
            f"{p.access_type}]")
    p = res["profile"]
    out.append("\n=== 3. workload memory behavior (paper §3.3, analytic "
               "nvprof) ===")
    out.append(f"  {p.label}: {p.l2_reads/1e6:.1f}M reads, "
               f"{p.l2_writes/1e6:.1f}M writes (R/W = {p.rw_ratio:.1f}), "
               f"{p.dram/1e3:.0f}K DRAM txns")
    out.append("\n=== 4. the verdict: NVM vs SRAM for this workload ===")
    for m, rel in res["verdict"].items():
        out.append(f"  {m}: {1/rel['total']:.1f}x less energy, "
                   f"{1/rel['edp_with_dram']:.1f}x lower EDP than SRAM")
    out.append("\n=== 5. iso-area: how much bigger can the NVM cache be? "
               "===")
    out.append(f"   {res['iso_area']} (paper: STT 7MB, SOT 10MB)")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(report(run(args.device))))


if __name__ == "__main__":
    main()
