"""Resolve a cell of ``BENCHMARK.json`` into its files, found by name:
``configs/<config>.json`` through the manifest's ``configs`` entry,
``workloads/<cell>.json`` (the system's settings for the cell and the
limits of its correctness numbers) and ``traffic/<traffic>.json`` (the
parameters the general generator reads).  A later PR adds a cell by adding
files and manifest entries; nothing here names a cell."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def resolve(name: str, bench: dict) -> dict:
    """The cell ``name``: its manifest entry, configuration file, workload
    file and traffic file, and the end-to-end and per-layer metrics it
    reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"name": name, "entry": entry, "config": config,
            "workload": workload, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def architecture(config: dict) -> dict:
    """The shapes the yardstick and the reference read, from a
    configuration file (Hugging Face ``config.json`` keys as run, and the
    file's ``architecture`` facts)."""
    c, a = config["config"], config["architecture"]
    if a["family"] != "dense":
        raise ValueError(f"{config['name']}: the yardstick and the reference "
                         f"know the dense decoder family only")
    return {
        "family": a["family"],
        "L": int(c["num_hidden_layers"]),
        "D": int(c["hidden_size"]),
        "H": int(c["num_attention_heads"]),
        "K": int(c["num_key_value_heads"]),
        "hd": int(a["head_dim"]),
        "F": int(c["intermediate_size"]),
        "V": int(c["vocab_size"]),
        "theta": float(c["rope_theta"]),
        "eps": float(c["rms_norm_eps"]),
        "tied": bool(c["tie_word_embeddings"]),
        "qkv_bias": bool(a["qkv_bias"]),
        "attn_scale": float(c.get("attention_multiplier",
                                  int(a["head_dim"]) ** -0.5)),
        "embedding_multiplier": float(c.get("embedding_multiplier", 1.0)),
        "residual_multiplier": float(c.get("residual_multiplier", 1.0)),
        "logits_scaling": float(c.get("logits_scaling", 1.0)),
    }


def port_config(arch: dict, name: str, remat: str = "full"):
    """The port's ``ModelConfig`` for ``arch``.  The port has no
    embedding, residual or logits multiplier and scales attention by
    head_dim^-0.5: a configuration that asks for other values is refused
    here rather than run as something else."""
    from repro_torch.configs.base import ModelConfig
    if (arch["embedding_multiplier"], arch["residual_multiplier"],
            arch["logits_scaling"]) != (1.0, 1.0, 1.0) \
            or abs(arch["attn_scale"] - arch["hd"] ** -0.5) > 1e-12:
        raise ValueError(f"{name}: the port applies no embedding, residual "
                         f"or logits multiplier and scales attention by "
                         f"head_dim^-0.5")
    if arch["eps"] != 1e-6:
        raise ValueError(f"{name}: the port's RMSNorm eps is 1e-6")
    kw = dict(arch=name, family=arch["family"], num_layers=arch["L"],
              d_model=arch["D"], num_heads=arch["H"],
              num_kv_heads=arch["K"], head_dim=arch["hd"], d_ff=arch["F"],
              vocab_size=arch["V"], qkv_bias=arch["qkv_bias"],
              rope_theta=arch["theta"], mlp_act="silu", gated_mlp=True,
              tie_embeddings=arch["tied"], dtype="bfloat16", remat=remat,
              fsdp=False)
    return ModelConfig(**kw)
