"""The port's runtime presets (``launch/tuning.py``) and the serve launcher's
``--budget``, ``--acc``, ``--load`` and ``--runtime-preset`` flags."""
import os
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.launch import serve as SV  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.launch import tuning as T  # noqa: E402  # repro: allow[tier1-deps] — the port under test


def test_alloc_conf_merges_key_by_key():
    assert T.merge_alloc_conf("expandable_segments:True", None) == "expandable_segments:True"
    # the operator's key wins; their other keys stay first
    assert T.merge_alloc_conf("expandable_segments:True,max_split_size_mb:64",
                              "max_split_size_mb:128, garbage_collection_threshold:0.6") == \
        "max_split_size_mb:128,garbage_collection_threshold:0.6,expandable_segments:True"
    assert T.merge_alloc_conf("expandable_segments:True", "expandable_segments:False") == \
        "expandable_segments:False"


def test_apply_preset_writes_only_what_is_missing():
    env = {"TORCH_CPP_LOG_LEVEL": "INFO", T.ALLOC_CONF: "max_split_size_mb:128"}
    wrote = T.apply_preset("serve", env)
    assert env[T.ALLOC_CONF] == "max_split_size_mb:128,expandable_segments:True"
    assert env["TORCH_CPP_LOG_LEVEL"] == "INFO" and "TORCH_CPP_LOG_LEVEL" not in wrote
    assert wrote == {T.ALLOC_CONF: env[T.ALLOC_CONF]}
    assert T.apply_preset("serve", env) == {}  # idempotent
    assert T.apply_preset("serve", env, force=True) == {"TORCH_CPP_LOG_LEVEL": "ERROR"}
    env = {}
    assert T.apply_preset("host-sim", env) == {"CUDA_VISIBLE_DEVICES": "",
                                                "TORCH_CPP_LOG_LEVEL": "ERROR"}
    assert T.apply_preset("bench", {})[T.ALLOC_CONF] == "expandable_segments:False"
    assert T.apply_preset("none", env) == {} and T.apply_preset(None, env) == {}
    with pytest.raises(ValueError, match="unknown runtime preset"):
        T.apply_preset("fast", env)
    # the uncached allocator breaks window-graph capture: no preset sets it
    assert all("PYTORCH_NO_CUDA_MEMORY_CACHING" not in p for p in T.PRESETS.values())


def test_apply_preset_warns_once_cuda_started(monkeypatch):
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.apply_preset("serve")  # CUDA not started: no warning
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.warns(RuntimeWarning, match="after CUDA initialized"):
        wrote = T.apply_preset("bench", force=True)
    assert wrote["TORCH_CPP_LOG_LEVEL"] == "ERROR"  # still written, for child processes
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.apply_preset("serve", {})  # a separate env is no process's: no warning


def test_host_sim_with_cuda_device_raises(monkeypatch):
    """host-sim hides every card before CUDA starts, so a run asking for the
    card fails in ``_cuda_or_cpu``, as any run without a card does."""
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: os.environ.get("CUDA_VISIBLE_DEVICES") != "")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SV.main(["--runtime-preset", "host-sim", "--device", "cuda", "--tiny"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""


def test_launcher_flags_reach_serve(monkeypatch):
    monkeypatch.setattr(os, "environ", dict(os.environ))
    seen = {}
    monkeypatch.setattr(SV, "serve_generative", lambda *a, **kw: seen.update(gen=kw))
    monkeypatch.setattr(SV, "serve", lambda *a, **kw: seen.update(cls=kw))
    SV.main(["--tiny", "--device", "cpu", "--budget", "0.3", "--acc", "0.95", "--load", "0.7",
             "--runtime-preset", "serve"])
    assert {k: seen["gen"][k] for k in ("budget", "acc", "load")} == \
        {"budget": 0.3, "acc": 0.95, "load": 0.7}
    assert os.environ[T.ALLOC_CONF].endswith("expandable_segments:True")
    SV.main(["--tiny", "--device", "cpu"])
    assert {k: seen["gen"][k] for k in ("budget", "acc", "load")} == \
        {"budget": SV.BUDGET, "acc": SV.ACC, "load": SV.LOAD} == \
        {"budget": 0.6, "acc": 0.99, "load": 0.5}
    SV.main(["--mode", "classification", "--tiny", "--device", "cpu", "--acc", "0.9"])
    assert {k: seen["cls"][k] for k in ("budget", "acc", "load")} == \
        {"budget": 0.02, "acc": 0.9, "load": 0.5}


def test_serve_generative_takes_budget_acc_load():
    """A tiny CPU run: the controller gets the budget and the constraint, the
    offered load sets the arrivals, and the report records all three."""
    kw = dict(n=3, decode_tokens=4, prompt_len=8, tiny=True, device="cpu", verbose=False)
    out, resp = SV.serve_generative("qwen2-1.5b", budget=0.25, acc=0.9, load=2.0, **kw)
    base, _ = SV.serve_generative("qwen2-1.5b", **kw)
    assert (out["budget"], out["acc"], out["load"]) == (0.25, 0.9, 2.0)
    assert (base["budget"], base["acc"], base["load"]) == (0.6, 0.99, 0.5)
    assert len(resp) == 3
    # a higher offered load packs the same requests into a shorter makespan
    assert out["simulated"]["vanilla"] != base["simulated"]["vanilla"]
