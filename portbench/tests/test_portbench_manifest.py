"""BENCHMARK.json against the contract's form: names, units, keys, files,
bounds, and the time a full check of 24 cells would take."""
import importlib.util
import json
import re

from portbench.cell import ROOT, architecture, manifest, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = manifest()
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in
                                                 b["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in (b["configs"], b["workloads"],
                  b["end_to_end"] + b["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


def test_every_cell_resolves_and_reports_enough():
    b = manifest()
    used = set()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in b["workloads"]:
        c = resolve(w["name"], b)
        used.add(w["config"])
        architecture(c["config"])
        reported = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in reported
    assert used == {c["name"] for c in b["configs"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        path = ROOT / "portbench" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
    assert len({m["layer"] for m in b["per_layer"]}) >= 4


def test_configs_state_their_cuts():
    for c in manifest()["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        assert set(f["published"]) == set(c["reduced"])
        for k in c["reduced"]:
            assert not (k.endswith("_dim") or k.endswith("_rank")
                        or "size" in k or k == "num_experts_per_tok")


def test_a_full_check_fits():
    b = manifest()
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
