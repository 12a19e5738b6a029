"""The benchmark's own rules: what its files may import and read, the
manifest's names and units, and that every cell finds its files by name."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.lib import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ccvpe_tpu"}
NOT_READ = ("benchmarks", "bench.py", "chip_smoke")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports_no_jax(path):
    """No module of the benchmark imports JAX or the JAX package, compared by
    whole top-level names (``ccvpe_torch`` begins with ``ccvpe_t``)."""
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ccvpe_torch" not in _imports(path)
    assert not {n for n in _imports(path)} - {"torch", "math", "typing", "__future__"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_old_benchmark(path):
    """Nothing the benchmark runs reads or imports the JAX-era benchmarks or
    the bring-up gate."""
    if path.parent.name == "tests":
        return
    text = path.read_text()
    for name in NOT_READ:
        assert name not in _imports(path)
        assert not re.search(rf"['\"/]{re.escape(name)}", text), name


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom ccvpe_tpu.models import cvm\nimport ccvpe_torch\n")
    assert _imports(bad) & FORBIDDEN == {"jax", "ccvpe_tpu"}


def _manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_names_and_units():
    b = _manifest()
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in (b["configs"], b["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for text in [w["why"] for w in b["workloads"]] + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert 1 <= b["run_seconds"] <= 51 and len(json.dumps(b)) <= 64 << 10


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_finds_its_files(cell):
    b = _manifest()
    c = harness.load_cell(cell, ROOT)
    assert (BENCH / "drivers" / f"{c.workload['driver']}.py").exists()
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["moves"] in {x["name"] for x in c.end_to_end}
    e2e = {x["name"] for x in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    conf = next(x for x in b["configs"] if x["name"] == c.workload["config"])
    assert conf["file"].startswith("portbench/")
    harness.precision_of(c.config)
    harness.precision_of(c.config, control=True)
    assert set(c.workload["checks"]) and all(v >= 0 for v in c.workload["checks"].values())


def test_every_config_is_used_and_matches_its_preset():
    from ccvpe_torch.models import cvm as program_cvm

    from portbench.lib import program
    from portbench.reference import cvm

    b = _manifest()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] == []
        program.preset(data, cvm.arch_from(data))
        assert data["preset"] in program_cvm.PRESETS
