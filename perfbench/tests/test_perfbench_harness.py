"""The harness is driven by data, refuses to run without a card, and loads
nothing of JAX or of the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import core

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msmctts_tpu"}


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert core.config(c["name"])["program"]["task"]
    for w in BENCH["workloads"]:
        wl = core.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], w["chips"])
        mix = core.mix(w["traffic"])
        assert hasattr(core.driver(mix["driver"]), "run")
    for m in BENCH["per_layer"]:
        reader = core.metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.WORKLOADS) == (
            m["layer"], m["unit"], m["moves"], m["workloads"]), m["name"]


def test_a_new_cell_is_only_files(tmp_path):
    """A throwaway cell added to a copy: a workload file and an entry, and
    the harness lists it and finds its files and metrics, with no other edit."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCH))
    base = b["workloads"][0]
    new = dict(base, name=base["config"] + ".throwaway", why="a copy, to show that a cell is data")
    b["workloads"].append(new)
    for m in b["per_layer"] + b["end_to_end"]:
        if base["name"] in m.get("workloads", []):
            m["workloads"].append(new["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "perfbench" / "workloads" / f"{new['name']}.json").write_text(
        json.dumps(dict(core.workload(base["name"]), why=new["why"])))
    here = tmp_path / "perfbench"
    listed = core.bench(tmp_path)
    assert new["name"] in [w["name"] for w in listed["workloads"]]
    assert core.workload(new["name"], here)["config"] == base["config"]
    assert core.mix(new["traffic"], here)["driver"]
    names = {m["name"] for m in core.cell_metrics(listed, new["name"], "per_layer")}
    assert names == {m["name"] for m in core.cell_metrics(BENCH, base["name"], "per_layer")}
    assert {m["name"] for m in core.cell_metrics(listed, new["name"], "end_to_end")} >= {"setup_s"}


def test_per_layer_metrics_move_what_their_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in core.cell_metrics(BENCH, cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for w in BENCH["workloads"]:
        e2e = {e["name"] for e in core.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(BENCH, w["name"], "per_layer")


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_run_fails_without_a_card(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    cell = BENCH["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip(), p.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_in_the_sources():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "msmctts_tpu_torch" not in tops, path


def test_no_jax_once_imported():
    """Import the runner, every driver, metric and the reference in a fresh
    process and look at sys.modules by whole top-level names."""
    code = (
        "import sys, runpy; sys.argv = ['run.py', '--help'];\n"
        "from pathlib import Path; import importlib\n"
        "try:\n    runpy.run_path('perfbench/run.py', run_name='__main__')\nexcept SystemExit:\n    pass\n"
        "from perfbench import core\n"
        "import perfbench.reference.judge_tts, perfbench.reference.judge_train, msmctts_tpu_torch.serving\n"
        "import msmctts_tpu_torch.training.vqgan_trainer\n"
        "for p in Path('perfbench/drivers').glob('*.py'): core.driver(p.stem)\n"
        "for p in Path('perfbench/metrics').glob('*.py'): core.metric(p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(%r)))\n" % sorted(FORBIDDEN)
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": "/tmp"})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]", p.stdout


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries_have_only_their_keys(kind):
    allowed = {"end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[kind]
    for m in BENCH[kind]:
        assert set(m) <= allowed, set(m) - allowed
        assert m["source"] in (("host_clock", "device_trace") if kind == "end_to_end" else
                               ("device_trace", "program_span", "program_counter", "host_clock"))
