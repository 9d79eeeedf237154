"""The readings the limits of ``correct`` are set from, for one cell on
several seeds in one process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--out <file>]

For each seed it runs the cell as ``run.py`` does (the timed path at the
cell's own sizes and load) and prints one JSON line with the program's
numbers and

- serve cells: the control's: at each position of the same sampled
  prompts and served tokens, the reference's best logit minus its logit
  of the token that the reference computed through float8 products
  (``Numerics("fp8")``, the step below the configuration's bf16) puts
  first (``logit_gap``), and ``sample_z`` of tokens drawn from the float8
  logits at each sampled request's temperature; besides, ``sample_z`` of
  two faults planted in the reference put in the program's place: the
  drawn token altered (the next id) and the draw made at temperature 1;
- train cells: the numbers of the float8 reference put in the program's
  place, and of the reference with half of each step's rows left out (a
  planted fault), each against the float32 reference.  A state left
  unchanged reads 1 on ``change`` by the measure itself and needs no run.

Each line also gives ``control_correct``: the control's numbers put
through the cell's limits as a run's are (``run.judge``), which has to
come out false.

The benchmark's own runs never run this.  It needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(ctx, driver, result) -> dict:
    """The program's numbers and the control's (and, training, the
    half-batch fault's) for one run."""
    from portbench import serve, train
    from portbench.reference.numerics import Numerics, strict_f32
    from portbench.run import judge
    strict_f32()
    lim = ctx.cell["workload"]["check"]
    if driver is serve:
        A, W, sample = ctx.arch, result["weights"], result["sample"]
        z = serve.sampled_z(A, W, result["sampled"], ctx.device, ctx.seed,
                            draws=fault_draws(A, W))
        out = {"program": {"logit_gap": serve.served_gaps(
                   A, W, sample, ctx.device), "sample_z": z["program"]},
               "control": {"logit_gap": serve.served_gaps(
                   A, W, sample, ctx.device, rank_num=Numerics("fp8")),
                   "sample_z": z["control"]},
               "faults": {"sample_z": {"altered": z["altered"],
                                       "temperature_1": z["hot"]}},
               "served_tokens": sum(len(o) for _, o in sample),
               "requests": len(sample),
               "sampled_tokens": sum(len(o) for _, o, _ in
                                     result["sampled"]),
               "sampled_requests": len(result["sampled"])}
    else:
        ref = train.reference(ctx)
        half = ctx.cell["traffic"]["batch"] // 2
        where = {}
        program = train.compare(ref, result["program"], where)
        out = {"program": program, "worst": where,
               "control": train.compare(ref, train.reference(
                   ctx, num=Numerics("fp8"))),
               "half_batch": train.compare(ref, train.reference(
                   ctx, rows=slice(0, half))),
               "losses": {"program": result["program"]["loss"],
                          "reference": ref["loss"]}}
    out["control_correct"] = judge(
        {k: {"value": v, "limit": lim[k]} for k, v in out["control"].items()})
    return out


def _gumbel_pick(logits, temperature: float, gen):
    """A draw from softmax(logits / temperature) by the Gumbel maximum."""
    import torch
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float64).clamp_(1e-300, 1.0 - 1e-16)
    return (logits.double() / temperature - torch.log(-torch.log(u))
            ).argmax(-1)


def fault_draws(arch: dict, W) -> dict:
    """Tokens drawn in the program's place at each sampled position: the
    control (from the float8 reference's logits), a token altered where
    it is drawn (the next id) and a draw at temperature 1."""
    from portbench.reference.decoder import sequence_logits
    from portbench.reference.numerics import Numerics

    def control(ref, served, temp, gen, seq, at):
        fp8 = sequence_logits(arch, W, seq, at, Numerics("fp8"))
        return _gumbel_pick(fp8, temp, gen)

    def altered(ref, served, temp, gen, seq, at):
        return (_gumbel_pick(ref, temp, gen) + 1) % ref.shape[-1]

    def hot(ref, served, temp, gen, seq, at):
        return _gumbel_pick(ref, 1.0, gen)

    return {"control": control, "altered": altered, "hot": hot}


def main(argv=None) -> int:
    from portbench.run import Ctx, set_cache_dirs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    set_cache_dirs()
    import time
    import torch
    from portbench import serve, train
    from portbench.cell import manifest, resolve
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = resolve(args.workload, manifest())
    driver = {"serve": serve, "train": train}[cell["workload"]["kind"]]
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Ctx(cell, seed, args.seconds, False, torch.device("cuda", 0))
        result = driver.run(ctx)
        t1 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               "end_to_end": result.get("end_to_end"),
               "memory_peak_bytes": result["memory_peak_bytes"],
               **readings(ctx, driver, result),
               "run_s": t1 - t0, "readings_s": time.perf_counter() - t1}
        del result
        ctx.free()
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
