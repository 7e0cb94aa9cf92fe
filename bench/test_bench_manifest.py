"""BENCHMARK.json against the contract it is held to, and the files it
names: names, units, lengths, each cell's and configuration's files, a
reader for every per-layer metric, each ``moves`` reported by all the
metric's cells."""
import json
import re

import pytest

from bench import harness as H

MAN = H.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["bench"]
    assert MAN["command"][1:] == ["bench/run.py"]


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_fields(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert set(m.get("workloads", [])) <= set(CELLS)


def test_names_unique():
    for group in (METRICS, MAN["workloads"], MAN["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def _e2e_of(cell: str) -> set:
    return {m["name"] for m in MAN["end_to_end"]
            if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("m", MAN["per_layer"],
                         ids=[m["name"] for m in MAN["per_layer"]])
def test_moves_is_reported_by_every_cell(m):
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in _e2e_of(cell)
    assert (H.BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("w", MAN["workloads"], ids=CELLS)
def test_cell_files(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cell = H.cell(w["name"])
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"] == w["traffic"]
    assert cell.workload["chips"] == w["chips"]
    assert (H.BENCH / "drivers" / f"{cell.workload['mode']}.py").is_file()
    e2e = _e2e_of(w["name"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(cell.workload["end_to_end"]) == e2e
    assert any(w["name"] in m.get("workloads", CELLS)
               for m in MAN["per_layer"])


def test_four_chip_cells():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("c", MAN["configs"],
                         ids=[c["name"] for c in MAN["configs"]])
def test_config_files(c):
    assert c["file"] == f"bench/configs/{c['name']}.json"
    f = H.load("configs", c["name"])
    assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                           for k in c["reduced"])
    widths = ("d_model", "d_ff", "head_dim", "n_heads", "n_kv_heads",
              "top_k")
    assert not set(c["reduced"]) & set(widths)
    assert c["name"] in {w["config"] for w in MAN["workloads"]}


@pytest.mark.parametrize("c", MAN["configs"],
                         ids=[c["name"] for c in MAN["configs"]])
def test_config_runs_as_the_port_states_it(c):
    """Every field the file states is the port's, but those it lists as
    reduced, assumed or taken from the source."""
    from repro_torch.configs import get_config
    f = H.load("configs", c["name"])
    port = get_config(f["port_config"])
    cfg = H.port_config(f["model"], f["port_config"])
    moved = set(c["reduced"]) | set(f["assumed"]) | \
        set(f.get("from_source", {}))
    for k, v in f["model"].items():
        if k == "moe":
            for kk, vv in v.items():
                assert getattr(cfg.moe, kk) == vv
            continue
        assert getattr(cfg, k) == v
        if k not in moved:
            assert getattr(port, k) == v, k
