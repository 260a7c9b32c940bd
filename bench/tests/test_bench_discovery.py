"""The harness is driven by data: a cell, a configuration and a per-layer
metric that a later change adds as new files and BENCHMARK.json entries
are found by name, with no existing file edited."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import check, harness, shapes

from . import helpers

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


# a configuration of a family the benchmark had no reference for (Llama's,
# as DeepSeek-67B publishes it), its reference module, a cell and a metric
LLAMA = {"model_type": "llama", "hidden_size": 8192, "intermediate_size": 22016,
         "num_attention_heads": 64, "num_key_value_heads": 8, "num_hidden_layers": 95,
         "vocab_size": 102400, "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
         "tie_word_embeddings": False, "attention_bias": False, "hidden_act": "silu",
         "torch_dtype": "bfloat16", "ramps": {"max_sites": 12, "style": "fc"},
         "port": {"config": "deepseek-67b", "decode_attn": "paged-kernel",
                  "pallas_head": "kernel",
                  "holds": {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
                            "num_attention_heads": "n_heads",
                            "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
                            "vocab_size": "vocab_size", "rope_theta": "rope_theta",
                            "tie_word_embeddings": "tie_embeddings"}}}
LLAMA_REF = ('"""Llama\'s plain reference: the shared decoder."""\n'
             "from bench.reference.decoder import Decoder as Reference  # noqa: F401\n\n\n"
             "def traits(c):\n    return {'qkv_bias': bool(c.get('attention_bias', False))}\n")


def _add(root: Path):
    man = json.loads((root / "BENCHMARK.json").read_text())
    (root / "bench/configs/deepseek-67b.json").write_text(json.dumps(LLAMA))
    (root / "bench/reference/llama.py").write_text(LLAMA_REF)
    man["configs"].append({"name": "deepseek-67b", "source": "https://example.org/cfg",
                           "file": "bench/configs/deepseek-67b.json", "reduced": [],
                           "why": "a configuration of a new family added as files"})
    mix = json.loads((root / "bench/workloads/qwen2-1.5b.decode.json").read_text())
    mix.update(traffic="chat.p512.o8-16", output={"dist": "uniform", "lo": 8, "hi": 16})
    (root / "bench/workloads/deepseek-67b.short.json").write_text(json.dumps(mix))
    man["workloads"].append({"name": "deepseek-67b.short", "config": "deepseek-67b",
                             "traffic": "chat.p512.o8-16", "chips": 1, "why": "added"})
    (root / "bench/metrics/calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.calls) / (ctx.t_close - ctx.t_open)\n")
    man["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                             "source": "host_clock", "layer": "runner", "moves": "out_tok_s",
                             "workloads": ["deepseek-67b.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_added_files_are_found(copy):
    before = {p: p.read_bytes() for p in (copy / "bench").rglob("*") if p.is_file()}
    _add(copy)
    cell = harness.load_cell("deepseek-67b.short", root=copy)
    assert cell.config["model_type"] == "llama" and cell.mix["output"]["hi"] == 16
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    assert {m["name"] for m in cell.end_to_end} >= {"out_tok_s", "setup_s"}
    read = harness.reader("calls_per_s", root=copy)
    ctx = type("Ctx", (), {"calls": [1, 2, 3], "t_open": 0.0, "t_close": 1.5})
    assert read(ctx) == 2.0
    # every file that was there is as it was
    assert all(p.read_bytes() == b for p, b in before.items())


def test_added_family_is_served_and_checked(copy):
    """The new family's cell, served on the CPU at a small size from the
    copy alone: the port held to the file's widths, the reference found by
    the file's model_type, the check correct."""
    _add(copy)
    code = (
        "import json, sys; sys.path[:0] = ['.', %r]\n"
        "from bench.reference import family\n"
        "from bench.tests import helpers\n"
        "s, win, chk = helpers.serve(helpers.small_cell('deepseek-67b.short'))\n"
        "print(json.dumps({'ref': family(s.arch['family']).__file__, 'bias': s.arch['qkv_bias'],"
        " 'L': s.arch['L'], 'tokens': chk['counts']['tokens'], 'program': chk['program'],"
        " 'correct': helpers.correct(chk)}))\n") % str(ROOT / "src")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    d = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(d["ref"]) == copy / "bench/reference/llama.py"
    assert d["bias"] is False and d["L"] == 4 and d["tokens"] >= 40 and d["correct"]
    assert d["program"]["final_gap"] < 1e-4 and d["program"]["ramp_gap"] < 1e-4


def test_port_is_held_to_the_files_widths():
    """A file whose width the port's config does not have is refused before
    anything is served; the published keys the port departs from
    (``as_run``) are not held."""
    cell = harness.load_cell("deepseek-v2-lite-16b.decode")
    from repro_torch.configs import get_config

    port = dict(cell.config["port"])
    view = harness.port_view(get_config(port["config"]), port["holds"])
    assert all(cell.config[k] == v for k, v in view.items())
    assert "norm_topk_prob" not in view and "rope_scaling" not in view
    cell.config = {**cell.config, "moe_intermediate_size": 1536}
    s = harness.Session(cell, 1, device="cpu")
    with pytest.raises(ValueError, match="moe_intermediate_size"):
        s.setup(0.0)


def test_published_keys_stay_and_the_reference_follows_as_run():
    cfg = harness.load_cell("deepseek-v2-lite-16b.decode").config
    assert cfg["norm_topk_prob"] is False and cfg["rope_scaling"]["type"] == "yarn"
    a = shapes.arch(cfg)
    assert a["norm_topk"] is True and a["qkv_bias"] is False and a["family"] == "deepseek_v2"
    with pytest.raises(ValueError, match="rope scaling"):
        shapes.arch({k: v for k, v in cfg.items() if k != "as_run"})
    with pytest.raises(ValueError, match="no reference"):
        shapes.arch({**cfg, "model_type": "no_such_family"})


def test_existing_cells_keep_their_metrics(copy):
    _add(copy)
    cell = harness.load_cell("deepseek-v2-lite-16b.decode", root=copy)
    assert "calls_per_s" not in {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("name", helpers.CELLS)
def test_every_cell_loads_and_has_its_readers(name):
    cell = helpers.load_cell(name)
    assert cell.mix["traffic"] == cell.entry["traffic"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    assert set(cell.mix["check"]["limits"]) <= {f"{n}{s}" for n in check.NUMBERS
                                                 for s in ("", "_mean")}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
