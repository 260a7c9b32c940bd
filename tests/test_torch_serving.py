"""The port's serving stack against the JAX package's: seeded runner
schedules at equal bucket shapes, the engine + controller end to end, and
the numpy modules the port copies (they must stay copies)."""
import ast
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as RC  # noqa: E402
import repro.core.profiles as ref_profiles  # noqa: E402
import repro.serving as RS  # noqa: E402
from repro.configs import get_config, get_tiny  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.core as TC  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
import repro_torch.core.profiles as port_profiles  # noqa: E402  # repro: allow[tier1-deps] — the port under test
import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_config as port_config  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test

SRC = Path(__file__).resolve().parents[1] / "src"
UNC_TOL = dict(rtol=1e-4, atol=1e-5)
P_LEN, MAX_NEW = 8, 12


def _models(seed=0):
    """Reference on its jnp decode oracle and dense head; the port on its
    main-path settings, whose kernels run their plain versions on CPU."""
    rm = ref_build(get_tiny("qwen2-1.5b").replace(decode_attn="ref"))
    tm = build_model(port_tiny("qwen2-1.5b").replace(decode_attn="kernel", pallas_head="kernel"))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    prompts = rng.integers(1, rm.cfg.vocab_size, (8, P_LEN))
    return rm, jax.tree.map(jnp.asarray, p), tm, from_numpy_params(p, "cpu"), prompts


def _same_records(t, r):
    for i, (a, b) in enumerate(zip(t, r)):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, **UNC_TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"record {i}")


def test_runner_schedules_agree():
    """Seeded admits, steps, sync windows and frees through both runners."""
    rm, rp, tm, tp, prompts = _models(0)
    kw = dict(max_new_tokens=MAX_NEW, max_slots=3, n_slots=4)
    ref = RS.DecodeRunner(rm, rp, prompts, **kw)
    port = TS.DecodeRunner(tm, tp, prompts, **kw)
    rng = np.random.default_rng(1)
    live, item, used = [], 0, {}
    done = {"start": 0, "step": 0, "multi": 0, "free": 0}
    for _ in range(24):
        op = str(rng.choice(["start", "step", "multi", "free"], p=[0.35, 0.25, 0.3, 0.1]))
        free_slots = [s for s in range(4) if s not in live]
        if op == "start" and free_slots and item < len(prompts):
            s = int(rng.choice(free_slots))
            assert port.start(s, item) == ref.start(s, item)
            live.append(s)
            used[s] = 0
            item += 1
            done[op] += 1
            continue
        if op == "free" and live:
            s = live.pop(int(rng.integers(len(live))))
            port.free(s)
            ref.free(s)
            done[op] += 1
            continue
        slots = sorted(s for s in live if used[s] < MAX_NEW - 4)
        if not slots:
            continue
        act = sorted(rng.choice(len(rm.sites), int(rng.integers(0, 3)), replace=False).tolist())
        if op == "step":
            _same_records(port.step(slots, act), ref.step(slots, act))
            n = 1
        else:
            n = int(rng.integers(1, 4))
            thr = rng.uniform(0.990, 0.999, len(act)).astype(np.float32)
            out_t = port.step_multi(slots, act, n, thr)
            out_r = ref.step_multi(slots, act, n, thr)
            _same_records(out_t, out_r)
            n = out_r[2].shape[0]
        for s in slots:
            used[s] += n
        done[op] += 1
    assert min(done.values()) >= 1 and done["start"] >= 3, done  # real work ran


def test_engine_end_to_end_agrees():
    """GenerativeEngine + ApparateController + DecodeRunner, both stacks
    handed ONE profile object: identical responses."""
    rm, rp, tm, tp, prompts = _models(2)
    prof = RC.build_profile(get_tiny("qwen2-1.5b"), mode="decode", chips=1,
                            sites=rm.sites, charge_kv=True)
    n, toks = 6, 6
    arr = RS.maf_trace(n, mean_qps=RS.offered_decode_qps(
        prof, max_batch_size=4, tokens_per_request=toks, load=0.7), seed=2)
    out = {}
    for name, S, C, model, params in (("ref", RS, RC, rm, rp), ("port", TS, TC, tm, tp)):
        reqs = S.make_gen_requests(arr, n_tokens=toks, prompt_len=P_LEN,
                                   slo_ms=3 * prof.vanilla_time(1))
        runner = S.DecodeRunner(model, params, prompts, max_new_tokens=toks + 2,
                                max_slots=2, n_slots=4)
        ctl = C.ApparateController(len(rm.sites), prof, C.ControllerConfig(
            max_slots=2, ramp_budget_frac=0.6))
        eng = S.GenerativeEngine(prof, S.GenerativeConfig(max_batch_size=4, steps_per_sync=3),
                                 runner, ctl)
        out[name] = (eng.run(reqs), eng.stats(), list(ctl.active))
    (rr, rstat, ract), (tr, tstat, tact) = out["ref"], out["port"]
    assert ract == tact and len(ract) > 0
    assert len(tr) == len(rr) == n
    for a, b in zip(tr, rr):
        assert (a.rid, a.tokens, a.final_tokens, a.exit_sites) == (
            b.rid, b.tokens, b.final_tokens, b.exit_sites)
        np.testing.assert_array_equal(a.release_ms, b.release_ms)
        assert len(a.tokens) == toks
    assert tstat == rstat
    assert RS.summarize_generative(rr) == TS.summarize_generative(tr)


# -- classification: the cluster engine over the real model --------------------

# (workers, dispatch, admission): one and two replicas under each dispatcher,
# and SLO-aware admission on one replica
SCHEDULES = [(w, d, False) for w in (1, 2) for d in ("round_robin", "jsq", "slo_aware")]
SCHEDULES.append((1, "jsq", True))


@pytest.fixture(scope="module")
def bert_stacks():
    """Tiny BERT in both packages on one perturbed seed, a 2-class token
    stream and ONE reference profile; each side's runner is shared across
    the schedules (a runner is a pure batch -> records function)."""
    from repro.data import make_token_stream

    rm = ref_build(get_tiny("bert-base"))
    tm = build_model(port_tiny("bert-base"), prefill_attn="kernel")
    rng = np.random.default_rng(0)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(0)))
    data = make_token_stream(160, seq_len=16, vocab=rm.cfg.vocab_size, n_classes=2,
                             mode="nlp", seed=3).data
    prof = RC.build_profile(get_tiny("bert-base"), mode="decode", chips=1)
    runners = {"ref": RS.ClassifierRunner(rm, jax.tree.map(jnp.asarray, p), data, max_slots=2),
               "port": TS.ClassifierRunner(tm, from_numpy_params(p, "cpu"), data, max_slots=2)}
    return rm, prof, runners


@pytest.mark.parametrize("workers,dispatch,admission", SCHEDULES)
def test_classification_cluster_end_to_end_agrees(bert_stacks, workers, dispatch, admission):
    """ClusterSimulator + ClassifierRunner + one ApparateController a worker,
    both stacks handed ONE profile object: identical responses (rid, label,
    exit site, release ms, dropped), controller stats and histories. The
    controllers accept 50% agreement and adjust every 32 samples, so the
    schedule exits and changes its ramp set; admission sheds requests."""
    rm, prof, runners = bert_stacks
    exec1 = prof.vanilla_time(1)
    arr = RS.maf_trace(160, mean_qps=workers * 0.5 * 1000.0 / exec1, seed=3)
    ccfg = dict(max_slots=2, ramp_budget_frac=0.5, acc_constraint=0.5, adjust_every=32,
                tune_window=64, min_samples_to_tune=16)
    out = {}
    for name, S, C in (("ref", RS, RC), ("port", TS, TC)):
        ctls = [C.ApparateController(len(rm.sites), prof, C.ControllerConfig(**ccfg))
                for _ in range(workers)]
        pf = S.PlatformConfig(policy="tfserve", max_batch_size=8, batch_timeout_ms=exec1)
        adm = S.AdmissionPolicy(S.AdmissionConfig(slack=1.0)) if admission else None
        sim = S.ClusterSimulator(prof, S.ClusterConfig(n_workers=workers, dispatch=dispatch,
                                                       platform=pf, admission=adm),
                                 runner=runners[name], controllers=ctls)
        resp = sim.run(S.make_requests(arr, slo_ms=2 * exec1))
        out[name] = ([(r.rid, r.label, r.exit_site, r.release_ms, r.dropped) for r in resp],
                     [c.stats["ramp_changes"] for c in ctls], [c.history for c in ctls],
                     sim.worker_stats())
    (rr, rch, rh, rws), (tr, tch, th, tws) = out["ref"], out["port"]
    assert tr == rr and len(tr) == 160
    assert (tch, tws) == (rch, rws)
    for a, b in zip(th, rh):
        assert [(e["kind"], e["sample"]) for e in a] == [(e["kind"], e["sample"]) for e in b]
    assert sum(r[2] >= 0 for r in tr) >= 1 and sum(rch) >= 1  # exits; a ramp-set change
    assert sum(r[4] for r in tr) >= (1 if admission else 0)  # admission shed requests
    if not admission:
        assert not any(r[4] for r in tr)


@pytest.mark.parametrize("config", ["resnet18", "bert-base", "qwen2-1.5b"])
def test_serve_classification_on_cpu_tiny(config):
    """The port's classification launcher end to end on the CPU at tiny size
    (an LM serves its next token): every request answered, the latencies
    labelled simulated, the runner's host times by bucket measured."""
    from repro_torch.launch.serve import serve  # repro: allow[tier1-deps] — the port under test

    out, resp = serve(config, 40, tiny=True, device="cpu", workers=2, verbose=False)
    assert len(resp) == 40 and not any(r.dropped for r in resp)
    m = out["measured"]
    assert m["device"] == "cpu" and sum(m["infer_calls_by_bucket"].values()) > 0
    assert set(m["infer_ms_by_bucket"]) <= {1, 2, 4, 8}
    assert m["ramp_set_variants"] + m["noramp_variants"] >= 1
    assert "not timed" in out["simulated"]["note"] and 0.0 <= out["accuracy"] <= 1.0
    assert len(out["active_ramps"]) == 2


def test_serve_generative_admission_on_cpu_tiny():
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    out, resp = serve_generative("gpt2-medium", 4, decode_tokens=5, prompt_len=8,
                                 steps_per_sync=3, tiny=True, device="cpu", verbose=False,
                                 admission=True, admission_slack=2.0)
    assert len(resp) == 4
    assert set(out["admission"]) == {"vanilla", "apparate"}


# -- the copied numpy modules ------------------------------------------------

COPIES = ["core/exits.py", "core/threshold_tuning.py", "core/ramp_adjust.py",
          "core/controller.py", "core/ramps.py", "serving/request.py",
          "serving/arrivals.py", "serving/engine.py", "serving/generative.py",
          "serving/metrics.py", "serving/policies.py", "serving/cluster.py",
          "serving/platform.py", "data/synthetic.py", "data/__init__.py"]


def _rewrite(src):
    return re.sub(r"\bfrom repro\.(core|serving|models|data)\b", r"from repro_torch.\1", src)


@pytest.mark.parametrize("rel", COPIES)
def test_numpy_module_is_a_verbatim_copy(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == _rewrite(ref)


def test_synthetic_runner_is_a_verbatim_copy():
    def source(path):
        text = path.read_text()
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, ast.ClassDef) and n.name == "SyntheticRunner")
        return ast.get_source_segment(text, node)

    rel = "serving/runner.py"
    assert source(SRC / "repro_torch" / rel) == source(SRC / "repro" / rel)


def test_profiles_copy_differs_only_in_h100_constants():
    ref = (SRC / "repro" / "core/profiles.py").read_text()
    port = (SRC / "repro_torch" / "core/profiles.py").read_text()
    tail = "\ndef _layer_flops_bytes("
    assert port[port.index(tail):] == _rewrite(ref[ref.index(tail):])
    assert (port_profiles.PEAK_FLOPS, port_profiles.HBM_BW) == (989e12, 3.35e12)


@pytest.mark.parametrize("cfg_name", ["qwen2-1.5b", "gpt2-medium"])
def test_profiles_match_under_equal_constants(monkeypatch, cfg_name):
    for mod in (ref_profiles, port_profiles):
        monkeypatch.setattr(mod, "PEAK_FLOPS", 5e14)
        monkeypatch.setattr(mod, "HBM_BW", 2e12)
    cr, ct = get_config(cfg_name), port_config(cfg_name)
    pr = RC.build_profile(cr, mode="decode", chips=1, charge_kv=True)
    pt = TC.build_profile(ct, mode="decode", chips=1, charge_kv=True)
    for f in ("layer_flops", "layer_bytes", "ramp_flops", "ramp_bytes", "layer_bytes_pi",
              "kv_flops", "kv_wbytes", "kv_pibytes"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pr, f), err_msg=f)
    assert pt.sites == pr.sites
    ex = np.array([-1, 0, 2, -1, 1])
    assert pt.decode_step_time(ex, [0, 1, 2]) == pr.decode_step_time(ex, [0, 1, 2])
    assert pt.vanilla_time(8) == pr.vanilla_time(8)


def test_controller_copy_behaves_identically():
    prof = RC.build_profile(get_config("qwen2-1.5b"), mode="decode", chips=1, charge_kv=True)
    ns = len(prof.sites)
    cc = dict(max_slots=4, ramp_budget_frac=0.6, adjust_every=64)
    ref = RC.ApparateController(ns, prof, RC.ControllerConfig(**cc))
    port = TC.ApparateController(ns, prof, TC.ControllerConfig(**cc))
    rng = np.random.default_rng(3)
    for _ in range(40):
        K = len(ref.active)
        lab = rng.integers(0, 4, (K, 8))
        unc = rng.uniform(0, 1, (K, 8)).astype(np.float32)
        fin = rng.integers(0, 4, 8)
        dr = ref.observe(lab, unc, fin)
        dt = port.observe(lab, unc, fin)
        np.testing.assert_array_equal(dt.exit_sites, dr.exit_sites)
        np.testing.assert_array_equal(dt.released_labels, dr.released_labels)
        assert port.active == ref.active
        np.testing.assert_array_equal(port.thresholds, ref.thresholds)
    assert ref.stats["tunes"] + ref.stats["adjusts"] > 0
    assert port.history == ref.history


def test_vanilla_engine_and_metrics_copies_agree():
    prof = RC.build_profile(get_config("qwen2-1.5b"), mode="decode", chips=1, charge_kv=True)
    arr_r = RS.maf_trace(40, mean_qps=50.0, seed=4)
    arr_t = TS.maf_trace(40, mean_qps=50.0, seed=4)
    np.testing.assert_array_equal(arr_t, arr_r)
    res = []
    for S in (RS, TS):
        reqs = S.make_gen_requests(arr_r, n_tokens=16, prompt_len=128, slo_ms=50.0)
        eng = S.GenerativeEngine(prof, S.GenerativeConfig(max_batch_size=8, steps_per_sync=4))
        resp = eng.run(reqs)
        res.append((S.summarize_generative(resp, horizon_ms=eng.makespan_ms), eng.stats(),
                    [(r.release_ms, r.exit_sites) for r in resp]))
    assert res[0] == res[1]


def test_serve_launcher_on_cpu_tiny():
    """The port's launcher end to end on the CPU at tiny size: every request
    completes its tokens, and the summary labels simulated vs measured."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    out, resp = serve_generative("gpt2-medium", 4, decode_tokens=5, prompt_len=8,
                                 steps_per_sync=3, tiny=True, device="cpu", verbose=False)
    assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
    assert out["measured"]["device"] == "cpu" and out["measured"]["windows"] > 0
    assert out["measured"]["decode_tokens"] == 4 * 4  # the prefill token is not a window's
    assert "not timed" in out["simulated"]["note"]
