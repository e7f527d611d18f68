"""The harness finds what is added as files: a configuration, a traffic
mix, a per-layer metric and a cell need new files and new entries in
``BENCHMARK.json`` only, and no file that is there changes."""
import hashlib
import json
import os

import pytest
from conftest import ROOT, TINY_DENSE, TINY_LIMITS, read_json, run_tiny, write_json

import check
import spec
from program import program_config


def _digests(root):
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "bench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_config_a_mix_and_a_metric_added_as_files_are_found(tiny_root):
    before = _digests(tiny_root)
    b = os.path.join(tiny_root, "bench")
    write_json(os.path.join(b, "configs", "tiny-new.json"), dict(TINY_DENSE, num_layers=2))
    short = read_json(os.path.join(b, "traffic", "healthy.json"))
    short["seq_len"] = 16
    write_json(os.path.join(b, "traffic", "short.json"), short)
    write_json(os.path.join(b, "limits", "tiny-new.short.json"), TINY_LIMITS)
    with open(os.path.join(b, "metrics", "steps_done.py"), "w") as f:
        f.write("def read(run):\n    return float(run.steps)\n")
    bm = read_json(os.path.join(tiny_root, "BENCHMARK.json"))
    bm["configs"].append({"name": "tiny-new", "source": "tiny", "reduced": [], "why": "tiny",
                          "file": "bench/configs/tiny-new.json"})
    bm["workloads"].append({"name": "tiny-new.short", "config": "tiny-new", "traffic": "short",
                            "chips": 1, "why": "tiny"})
    bm["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                            "source": "host_clock", "layer": "train step",
                            "moves": "tokens_per_s", "workloads": ["tiny-new.short"]})
    write_json(os.path.join(tiny_root, "BENCHMARK.json"), bm)
    cell = spec.load_cell(tiny_root, "tiny-new.short", b)
    assert cell.seq_len == 16 and cell.sizes["layers"] == 2
    res, _rows = run_tiny(tiny_root, "tiny-new.short", trace=True)
    assert res["metrics"]["steps_done"]["value"] == res["steps"] > 0
    assert res["correct"]
    after = _digests(tiny_root)
    assert {p: h for p, h in after.items() if p in before} == before


@pytest.mark.parametrize("config", sorted(os.listdir(os.path.join(ROOT, "bench", "configs"))))
@pytest.mark.parametrize("traffic", sorted(os.listdir(os.path.join(ROOT, "bench", "traffic"))))
def test_each_configuration_states_what_the_program_runs(config, traffic):
    cell = spec.Cell("x", config, traffic,
                     read_json(os.path.join(ROOT, "bench", "configs", config)),
                     read_json(os.path.join(ROOT, "bench", "traffic", traffic)), {}, 1)
    cfg = program_config(cell)  # raises where a size differs from the file's
    assert cfg.n_layers == cell.sizes["layers"]


@pytest.mark.parametrize("name", [w["name"] for w in read_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]])
def test_each_cell_holds_every_number_to_a_limit(name):
    cell = spec.load_cell(ROOT, name)
    assert set(cell.limits) == set(check.NUMBERS)
    assert all(0 < v < 0.1 for v in cell.limits.values())


def test_benchmark_json_keeps_the_contract():
    bm = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(bm) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert len(json.dumps(bm)) < 64 * 1024
    names = [c["name"] for c in bm["configs"]]
    cells = {w["name"]: w for w in bm["workloads"]}
    e2e = {m["name"] for m in bm["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for c in bm["configs"]:
        assert c["file"].startswith(bm["paths"][0] + "/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in bm["workloads"])
    for w in bm["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "bench", "traffic", f"{w['traffic']}.json"))
    for m in bm["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bm["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert os.path.exists(os.path.join(ROOT, "bench", "metrics", f"{m['name']}.py"))
    for w in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert any(w in m["workloads"] for m in bm["per_layer"])


def test_a_cell_without_its_limits_file_is_refused(tiny_root):
    """The check fails closed: a cell whose limits file is missing (or
    misnamed) does not load, except to read the numbers its limits are to
    be set from, and then no number holds."""
    b = os.path.join(tiny_root, "bench")
    os.remove(os.path.join(b, "limits", "tiny-dense.healthy.json"))
    with pytest.raises(FileNotFoundError, match="tiny-dense.healthy"):
        spec.load_cell(tiny_root, "tiny-dense.healthy", b)
    cell = spec.load_cell(tiny_root, "tiny-dense.healthy", b, calibrate=True)
    assert cell.limits == {}
    res, rows = run_tiny(tiny_root, "tiny-dense.healthy", calibrate=True)
    assert not res["correct"] and res["failed"] == len(check.NUMBERS)
    assert all(lim is None for _, _, lim in rows)
