"""The manifest finds every cell's configuration, traffic mix, driver and
per-layer readers by name, and a mix or metric added as files alone is found
without editing a file."""

from __future__ import annotations

import json
import shutil

from fisrbench.harness.manifest import BENCH_DIR, ROOT, Manifest


def test_every_cell_resolves():
    m = Manifest()
    assert m.spec["workloads"]
    for w in m.spec["workloads"]:
        cell = m.cell(w["name"])
        cfg = m.config(cell["config"])
        assert cfg
        mix = m.mix(cell["traffic"])
        assert hasattr(m.driver(mix), "run")
        e2e = {x["name"] for x in m.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = m.per_layer(w["name"])
        assert layers
        for metric in layers:
            assert metric["moves"] in e2e
            assert callable(m.reader(metric["name"]))


def test_contract_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def test_added_mix_and_metric_need_no_edit(tmp_path):
    bench = tmp_path / "fisrbench"
    shutil.copytree(BENCH_DIR / "configs", bench / "configs")
    (bench / "workloads").mkdir(parents=True)
    (bench / "metrics").mkdir()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec["workloads"][0]
    mix = json.loads((BENCH_DIR / "workloads" / f"{cell['traffic']}.json").read_text())
    (bench / "workloads" / "dummy-mix.json").write_text(json.dumps(dict(mix, note="dummy")))
    (bench / "metrics" / "dummy_idle.video.py").write_text(
        "from fisrbench.harness.readers import device_idle_pct\n\nread = device_idle_pct\n")
    spec["workloads"].append(dict(cell, name="dummy-cell", traffic="dummy-mix"))
    spec["per_layer"].append({"name": "dummy_idle.video", "unit": "%", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "setup_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    m = Manifest(root=tmp_path, bench_dir=bench)
    assert m.mix(m.cell("dummy-cell")["traffic"])["note"] == "dummy"
    assert [x["name"] for x in m.per_layer("dummy-cell")] == ["dummy_idle.video"]
    read = m.reader("dummy_idle.video")
    assert read({"trace": {"busy_s": 1.0, "window_s": 4.0}}) == 75.0
