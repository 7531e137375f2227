"""BENCHMARK.json against the contract, and every name it holds against its file."""

import json
import re

import pytest

from benchmark.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == KEYS["cell"] and w["chips"] in (1, 4) and _line(w["why"])
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert {(w["config"], w["traffic"]) for w in bench["workloads"]}.__len__() == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_name_finds_its_file(bench):
    for w in bench["workloads"]:
        cfg, mix = spec.config(w["config"], bench), spec.traffic(w["traffic"])
        assert callable(spec.rig_builder(cfg["rig"]["builder"]).build)
        clock = spec.generator(mix["generator"]).Clock
        assert isinstance(clock.paced, bool) and all(callable(getattr(clock, f)) for f in ("next_tick", "capture_time", "hold"))
        assert spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    for c in bench["configs"]:
        body = spec.config(c["name"], bench)
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert sum(x["config"] == c["name"] for x in bench["workloads"]) >= 1
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.metrics_for(w["name"], bench, trace=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_for(w["name"], bench, trace=True)


def test_moves_is_reported_in_each_cell_of_the_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)


def test_layers_are_named_alike(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_rooflines_are_named_for_their_kernels(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert spec.reader(m["name"]).KERNELS


def test_files_are_named_from_name_characters():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert PATH.match(rel), rel


def test_limits_name_only_numbers_the_check_makes(bench):
    poses = {f"{a}{m}_{u}" for a in ("pose_err", "rpe") for m in ("", "_med") for u in ("mm", "mrad")}
    known = poses | {"steps_off_pct", "depth_bad_px_pct", "tsdf_bad_vox_pct"}
    for w in bench["workloads"]:
        lim = spec.limits(w["name"])
        assert set(lim) <= known and set(lim) & poses and all(v > 0 for v in lim.values())
        cfg = spec.config(w["config"], bench)
        mix = spec.traffic(w["traffic"])
        if cfg.get("rgbd") and mix.get("rgbd_every"):
            assert {"depth_bad_px_pct"} <= set(lim)
        if cfg.get("mapping") and mix.get("map"):
            assert {"tsdf_bad_vox_pct"} <= set(lim)
    json.dumps(bench)
