"""The port's multi-rank serving against the JAX package's single-device
paths, on gloo ranks spawned on the CPU (``launch.mesh.spawn``; each job's
store a ``file://`` path under a temporary directory, so concurrent test
workers never share a port). The reference runs here in the parent, in
process, and reaches the ranks as numpy; the rank bodies live in
``torch_dist_ranks.py`` so a rank never imports JAX.

Two jobs carry every case: two ranks (tensor-parallel decode at tp 2 on
contiguous rows and on the paged pool, ``decode_sharded_multi`` windows,
expert-parallel MoE inside TP, ``init_sharded``, ``ShardedDecodeRunner``
paired call by call with the reference's ``DecodeRunner``, the pipeline
window at S 1 and 2) and four ranks (tp 4, dp 2 x tp 2, the pipeline at S
4). The reference's own multi-device paths are not the anchor: its
``decode_sharded`` at tp 4 and its pipeline window's cache at S 4 differ
from its single-device paths on this JAX (ROADMAP Queue 3 item 3).

Tolerance rule: stats and caches within 1e-5; labels, exit masks and
sites, ``n_done``, tokens and allocator state exact; the ranks' records,
tokens and allocator states equal across ranks bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.serving as RS  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.distributed.pipeline import pipeline_check as ref_pipeline_check  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import torch_dist_ranks as R  # noqa: E402  # repro: allow[tier1-deps] — the rank bodies beside this file (torch + the port)
from repro_torch.distributed.pipeline import pipeline_check  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch import serve as SV  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.launch.mesh import spawn  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)
B, S0 = 4, 8  # decode rows, prompt length
ACT = [0, 1]
MAX_NEW = 12
P_LEN = 10


def ref_model(name, **kw):
    arch, over = R.MODELS[name]
    return ref_build(get_tiny(arch).replace(**over, **kw))


@functools.lru_cache(maxsize=None)
def weights(name, seed=0):
    """The reference's init, every leaf perturbed so zero-initialized norms
    take part (numpy tree)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                        .astype(np.float32), ref_model(name).init(jax.random.PRNGKey(seed)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prefill(name, seed=1):
    """A B x S0 prompt prefilled by the reference into a 32-row cache:
    (model, jnp params, numpy cache, last tokens, pos)."""
    m = ref_model(name, decode_attn="ref")
    p = jax.tree.map(jnp.asarray, weights(name))
    toks = jax.random.randint(jax.random.PRNGKey(seed), (B, S0), 0, m.cfg.vocab_size)
    cache, outs = m.prefill(p, toks, cache_len=32, moe_impl="dense")
    last = np.asarray(outs["final"]["label"]).reshape(B, 1).astype(np.int32)
    return m, p, _np(cache), last, np.full((B,), S0, np.int32)


def _decode_case(name, moe_impl="dense"):
    m, p, cache, last, pos = _prefill(name)
    thr = np.array([0.5, 0.5], np.float32)
    rc, ro = m.decode(p, jax.tree.map(jnp.asarray, cache), jnp.asarray(last), jnp.asarray(pos),
                      active_sites=jnp.asarray(ACT, jnp.int32), moe_impl=moe_impl,
                      exit_thresholds=jnp.asarray(thr))
    case = {"params": weights(name), "cache": cache, "tok": last, "pos": pos, "act": ACT,
            "thr": thr}
    return case, {"outs": _np(ro), "cache": _np(rc)}


def _window_case(name):
    """Windows of 3 (n_max 4): thresholds 0.5 with the first two rows
    invalid (under dp 2 one data shard holds only invalid rows, so its own
    all-exited test would end the window), then near-1.0 thresholds (every
    row exits at the first step)."""
    m, p, cache, last, pos = _prefill(name)
    variants = [(np.array([0.5, 0.5], np.float32), np.array([False, False, True, True])),
                (np.full(2, 0.9999, np.float32), np.ones(B, bool))]
    refs = []
    for thr, valid in variants:
        rc, rec = m.decode_multi(p, jax.tree.map(jnp.asarray, cache), jnp.asarray(last),
                                 jnp.asarray(pos), 3, n_max=4,
                                 active_sites=jnp.asarray(ACT, jnp.int32),
                                 thresholds=jnp.asarray(thr), row_valid=jnp.asarray(valid),
                                 moe_impl="dense")
        refs.append({"recs": [np.asarray(r) for r in rec], "cache": _np(rc)})
    case = {"params": weights(name), "cache": cache, "tok": last, "pos": pos, "act": ACT,
            "variants": variants, "n": 3, "n_max": 4}
    return case, refs


def _paged_case():
    """Random pool contents and a table of 4 live rows on a 13-block pool."""
    m = ref_model("qwen2", decode_attn="paged")
    rng = np.random.default_rng(5)
    nb, P = 3, 13
    sch = m.paged_cache_schema(P, R.BS)
    pool = jax.tree.map(lambda i: rng.standard_normal(i.shape).astype(np.float32), sch,
                        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    table = (rng.permutation(P - 1) + 1)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = np.array([5, 9, 11, 2], np.int32)
    tok = rng.integers(0, m.cfg.vocab_size, (B, 1)).astype(np.int32)
    thr = np.array([0.5, 0.9], np.float32)
    p = jax.tree.map(jnp.asarray, weights("qwen2"))
    rc, ro = m.decode(p, jax.tree.map(jnp.asarray, pool), jnp.asarray(tok), jnp.asarray(pos),
                      active_sites=jnp.asarray(ACT, jnp.int32), block_tables=jnp.asarray(table),
                      exit_thresholds=jnp.asarray(thr))
    case = {"params": weights("qwen2"), "cache": pool, "tok": tok, "pos": pos, "act": ACT,
            "thr": thr, "tables": table}
    return case, {"outs": _np(ro), "cache": _np(rc)}


def _prompts():
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, 512, (6, P_LEN))
    prompts[1] = prompts[0]  # a whole-prompt hit
    prompts[2, :8] = prompts[0, :8]  # a partial hit: two shared blocks
    return prompts


def _runner_case(name="qwen2", layout="pages"):
    kw = {"max_new_tokens": MAX_NEW, "max_slots": 2, "n_slots": 4}
    if layout == "pages":
        kw.update(kv_block_size=R.BS, kv_blocks=11, prefix_cache=True)
    m = ref_model(name, decode_attn="paged" if layout == "pages" else "ref")
    ref = RS.DecodeRunner(m, jax.tree.map(jnp.asarray, weights(name)), _prompts(), **kw)
    calls = R.schedule(ref, RS.PoolExhausted, layout)
    return ({"params": weights(name), "prompts": _prompts(), "kw": kw},
            {"calls": calls, "kv": ref.kv_stats(), "pool": _np(ref._cache)})


def _pipe_case():
    """The reference's per-step greedy loop (3 steps) from a prefill, and
    near-1.0 thresholds at each stage boundary's ramp for S 2 and 4."""
    m, p, cache, last, pos = _prefill("pipe")
    c, t, toks = jax.tree.map(jnp.asarray, cache), jnp.asarray(last), []
    for k in range(3):
        c, o = m.decode(p, c, t, jnp.asarray(pos) + k, moe_impl="dense")
        t = o["final"]["label"].reshape(B, 1).astype(jnp.int32)
        toks.append(np.asarray(o["final"]["label"]).reshape(B))
    sites, ns = list(m.sites), len(m.plan.period)
    exit_kw = {}
    for S in (2, 4):
        Lp = m.plan.n_periods // S
        a = [sites.index(b) for b in [(s + 1) * Lp * ns - 1 for s in range(S - 1)]
             if b in sites]
        assert a, f"S={S}: no boundary ramp in sites={sites}"
        exit_kw[S] = {"active_sites": a, "thresholds": [0.9999] * len(a)}
    case = {"params": weights("pipe"), "cache": cache, "tok": last, "pos": pos, "n": 3,
            "exit": exit_kw}
    return case, {"tok": np.stack(toks), "cache": _np(c)}


@functools.lru_cache(maxsize=None)
def runs():
    """The reference's results and both jobs' rank results."""
    rows, rows_ref = _decode_case("qwen2")
    paged, paged_ref = _paged_case()
    window, window_ref = _window_case("qwen2")
    ep, ep_ref = _decode_case("moe")
    runner, runner_ref = _runner_case()
    pipe, pipe_ref = _pipe_case()
    rows4, rows4_ref = _decode_case("qwen2_kh4")
    window4, window4_ref = _window_case("qwen2_kh4")
    runner4, runner4_ref = _runner_case("qwen2_kh4", "rows")
    two = spawn(R.job_two, 2, "gloo", device="cpu",
                args=({"rows": rows, "paged": paged, "window": window, "ep": ep,
                       "runner": runner, "pipe": pipe},))
    four = spawn(R.job_four, 4, "gloo", device="cpu",
                 args=({"rows": rows4, "window": window4, "pipe": pipe, "runner": runner4},))
    ref = {"rows": rows_ref, "paged": paged_ref, "window": window_ref, "ep": ep_ref,
           "runner": runner_ref, "pipe": pipe_ref, "rows4": rows4_ref, "window4": window4_ref,
           "runner4": runner4_ref}
    return ref, two, four


def _kv_shard(x, rank, m):
    """Rank ``rank``'s kv-head block of a cache leaf (kv heads at ndim - 2)."""
    n = x.shape[-2] // m
    return x[..., rank * n:(rank + 1) * n, :]


def _check_outs(got, want, live=slice(None)):
    for part, st in want.items():
        for k, v in st.items():
            a, b = got[part][k][..., live], np.asarray(v).reshape(got[part][k].shape)[..., live]
            if k in ("label", "exit"):
                np.testing.assert_array_equal(a, b, err_msg=f"{part}.{k}")
            else:
                np.testing.assert_allclose(a, b, err_msg=f"{part}.{k}", **TOL)


def _check_cache(got, want, rank, m, data_rank=0, dp=1, pool=False):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = _kv_shard(np.asarray(b), rank, m)
        if dp > 1:
            n = b.shape[-4] // dp
            b = np.take(b, range(data_rank * n, (data_rank + 1) * n), axis=b.ndim - 4)
        if pool:  # outside the trash block 0
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_allclose(a, b, **TOL)


def _same_across_ranks(results, key):
    """Records (not caches) equal bit for bit on every rank."""
    def strip(r):
        r = r[key]
        return r["outs"] if isinstance(r, dict) and "outs" in r else r
    first = jax.tree.leaves(strip(results[0]))
    for other in results[1:]:
        for a, b in zip(first, jax.tree.leaves(strip(other))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", ["rows", "paged", "ep"])
def test_tp2_decode_matches_reference(key):
    """tp 2 on contiguous rows and on the paged pool, and expert-parallel
    MoE inside TP (capacity 8: nothing drops) against the dense dispatch:
    records, exit masks and each rank's cache shard; records alike on both
    ranks."""
    ref, two, _ = runs()
    for rank, res in enumerate(two):
        _check_outs(res[key]["outs"], ref[key]["outs"])
        _check_cache(res[key]["cache"], ref[key]["cache"], rank, 2, pool=key == "paged")
    _same_across_ranks(two, key)


@pytest.mark.parametrize("key", ["tp4", "dp2"])
def test_tp4_and_dp2_decode_match_reference(key):
    """tp 4 (4 kv heads, one a rank) and dp 2 x tp 2 on contiguous rows:
    records gathered over data, each rank's rows and heads of the cache."""
    ref, _, four = runs()
    for rank, res in enumerate(four):
        _check_outs(res[key]["outs"], ref["rows4"]["outs"])
        if key == "tp4":
            _check_cache(res[key]["cache"], ref["rows4"]["cache"], rank, 4)
        else:
            d, mi = res["coords"]
            _check_cache(res[key]["cache"], ref["rows4"]["cache"], mi, 2, d, 2)
    _same_across_ranks(four, key)


@pytest.mark.parametrize("job,key,m,dp", [("two", "window", 2, 1),
                                          ("four", "window_dp2", 2, 2)])
def test_decode_sharded_multi_matches_decode_multi(job, key, m, dp):
    """Windows against the reference's ``decode_multi``: records up to
    n_done, n_done exact (under dp 2 the all-exited test is summed over
    the data group, so a shard of invalid rows does not end the window),
    and the cache."""
    ref, two, four = runs()
    results, want = (two, ref["window"]) if job == "two" else (four, ref["window4"])
    for rank, res in enumerate(results):
        for got, exp in zip(res[key], want):
            nd = int(exp["recs"][4])
            assert int(got["recs"][4]) == nd
            for i, (a, b) in enumerate(zip(got["recs"][:4], exp["recs"][:4])):
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a[:nd], b[:nd], err_msg=f"rec {i}", **TOL)
                else:
                    np.testing.assert_array_equal(a[:nd], b[:nd], err_msg=f"rec {i}")
            d, mi = res.get("coords", (0, rank))
            _check_cache(got["cache"], exp["cache"], mi, m, d, dp)
    assert [int(e["recs"][4]) for e in want] == [3, 1]


def test_init_sharded_equals_slice_of_init():
    _, two, _ = runs()
    assert [r["init"] for r in two] == [[], []]


def _check_calls(got, want):
    """Every call's records within tolerance; statuses, tokens, positions,
    allocator state and ``kv_stats()`` exact."""
    assert len(got["calls"]) == len(want["calls"])
    for i, ((sa, ra, sta), (sb, rb, stb)) in enumerate(zip(got["calls"], want["calls"])):
        assert sa == sb, i
        assert sta == stb, i
        if isinstance(rb, tuple):
            for a, b in zip(ra, rb):
                if np.asarray(a).dtype.kind == "f":
                    np.testing.assert_allclose(a, np.asarray(b), err_msg=str(i), **TOL)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(i))
        else:
            assert ra == rb, i


def test_sharded_runner_pairs_with_reference_runner():
    """``ShardedDecodeRunner`` (tp 2, the paged pool with a prefix cache on
    11 blocks) and the reference's ``DecodeRunner`` through one schedule:
    every call's records within tolerance, tokens, statuses and allocator
    state exact; both ranks alike; a rank holds half the pool's bytes."""
    ref, two, _ = runs()
    want = ref["runner"]
    for res in two:
        got = res["runner"]
        _check_calls(got, want)
        assert got["kv"]["tp"] == 2 and got["kv"]["dp"] == 1
        assert got["kv"]["per_device_cache_bytes"] == want["kv"]["cache_bytes"] / 2
    statuses = [c[0] for c in want["calls"]]
    assert "exhausted" in statuses and statuses.count("ok") >= 12
    for rank, res in enumerate(two):
        _check_cache(res["runner"]["pool"], want["pool"], rank, 2, pool=True)
    calls = [[(c[0], c[2]) for c in r["runner"]["calls"]] for r in two]
    assert calls[0] == calls[1]


def test_sharded_runner_dp2_rows_pairs_with_reference_runner():
    """``ShardedDecodeRunner`` at dp 2 x tp 2 on contiguous rows (each rank
    decodes its data shard's rows and gathers the rest) against the
    reference's ``DecodeRunner``: records, tokens and state as above; every
    rank alike; a rank holds every row of its kv-head block."""
    ref, _, four = runs()
    for res in four:
        _check_calls(res["runner_dp2"], ref["runner4"])
        kv = res["runner_dp2"]["kv"]
        assert (kv["tp"], kv["dp"]) == (2, 2)
        assert kv["per_device_cache_bytes"] == ref["runner4"]["kv"]["cache_bytes"] / 2
        d, mi = res["coords"]
        _check_cache(res["runner_dp2"]["pool"], ref["runner4"]["pool"], mi, 2)
    calls = [[(c[0], c[2]) for c in r["runner_dp2"]["calls"]] for r in four]
    assert all(c == calls[0] for c in calls)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_pipeline_window_matches_greedy_loop(S):
    """Thresholds off: the window's tokens equal the reference's per-step
    greedy loop and each stage's cache its periods of the loop's cache, no
    row exits; near-1.0 boundary thresholds: rows exit at a stage edge and
    the last stage does strictly less work than the first."""
    ref, two, four = runs()
    results = {1: two[:1], 2: two, 4: four}[S]
    key = f"pipe{S}"
    want = ref["pipe"]
    for stage, res in enumerate(results):
        off = res[key]["off"]
        np.testing.assert_array_equal(off["tok"], want["tok"])
        assert off["alive"].all() and (off["exit"] < 0).all()
        for a, b in zip(jax.tree.leaves(off["cache"]), jax.tree.leaves(want["cache"])):
            n = b.shape[0] // S
            np.testing.assert_allclose(a, np.asarray(b)[stage * n:(stage + 1) * n], **TOL)
        if S > 1:
            on = res[key]["on"]
            assert on["steps"][-1] < on["steps"][0], on["steps"]
            assert (on["exit"] >= 0).sum() > 0
            np.testing.assert_array_equal(on["steps"], results[0][key]["on"]["steps"])


def test_check_texts_equal_the_reference():
    """``tp_check`` and ``pipeline_check`` raise the reference's words."""
    def msg(fn, *a, **kw):
        try:
            fn(*a, **kw)
        except NotImplementedError as e:
            return str(e)
        return None

    cases = [("mamba2-2.7b", 2, {}), ("deepseek-v2-lite-16b", 2, {}),
             ("llama-3.2-vision-90b", 2, {}), ("qwen2-1.5b", 3, {}),
             ("qwen2-1.5b", 2, {"dp": 2}), ("qwen2-1.5b", 1, {"dp": 2, "paged": False,
                                                             "batch": 3}),
             ("qwen3-moe-30b-a3b", 8, {}), ("qwen2-1.5b", 2, {"dp": 1})]
    seen = []
    for arch, tp, kw in cases:
        a = msg(ref_build(get_tiny(arch)).tp_check, tp, **kw)
        b = msg(R.build_model(R.get_tiny(arch)).tp_check, tp, **kw)
        assert a == b, (arch, tp, kw)
        seen.append(a)
    assert all(seen[:-1]) and seen[-1] is None
    pcases = [("qwen2-1.5b", {"decode_attn": "paged"}, 2), ("qwen2-1.5b", {}, 2),
              ("qwen2-1.5b", {"pallas_head": "kernel"}, 1), ("gemma3-4b", {}, 1),
              ("qwen3-moe-30b-a3b", {}, 1), ("mamba2-2.7b", {}, 1),
              ("deepseek-v2-lite-16b", {}, 1)]
    for arch, over, S in pcases:
        a = msg(ref_pipeline_check, ref_build(get_tiny(arch).replace(**over)), S)
        b = msg(pipeline_check, R.build_model(R.get_tiny(arch).replace(**over)), S)
        assert a == b and a, (arch, over, S)
    assert "block pool shards per-device" in msg(
        pipeline_check, R.build_model(R.get_tiny("qwen2-1.5b").replace(decode_attn="paged")), 2)


def test_spawn_raises_a_failing_rank(tmp_path):
    """A rank that raises fails the whole call, with its traceback, while
    the other rank waits in a collective."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(R.job_raise, 2, "gloo", device="cpu", store_dir=str(tmp_path))


def test_backends_are_named_and_nccl_needs_a_card_a_rank():
    with pytest.raises(ValueError, match="name one of"):
        spawn(R.job_raise, 2, "mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        spawn(R.job_raise, 2, "nccl", device="cpu")


def test_serve_launcher_tp2_pp2_on_cpu(capsys):
    """``--tp 2 --pp 2 --tiny --device cpu --dist-backend gloo``: rank 0's
    report with the mesh, per-device cache bytes half the cache's, and the
    pipeline demo's per-stage work."""
    SV.main(["--tp", "2", "--pp", "2", "--tiny", "--device", "cpu", "--dist-backend", "gloo",
             "--n", "4", "--decode-tokens", "6", "--prompt-len", "12"])
    out = capsys.readouterr().out
    import json

    rep = json.loads(out[out.index("{"):])
    assert rep["mesh"] == {"tp": 2, "dp": 1}
    assert rep["kv_cache"]["per_device_cache_bytes"] == rep["kv_cache"]["cache_bytes"] / 2
    pipe = rep["pipeline"]
    assert pipe["stages"] == 2 and pipe["n_layers"] % 2 == 0
    assert len(pipe["stage_steps_no_exit"]) == 2
    assert pipe["stage_steps_no_exit"][0] == pipe["batch"] * 6
    with pytest.raises(SystemExit):
        SV.main(["--tp", "2", "--tiny", "--device", "cpu"])  # no backend named


def test_sharded_runner_refuses_whole_params():
    """The runner holds only the rank's shard: a whole tree is refused at
    construction (before any collective, so no job is needed)."""
    from repro_torch.launch.mesh import ServingMesh  # repro: allow[tier1-deps] — the port under test

    model = R.port_model("qwen2", decode_attn="kernel", pallas_head="kernel")
    mesh = ServingMesh(2, 1, 1, 0, {"data": 0, "model": 0}, {"model": None, "data": None},
                       torch.device("cpu"), "gloo")
    prompts = np.ones((2, 4), np.int64)
    with pytest.raises(ValueError, match="rank's shard"):
        R.ShardedDecodeRunner(model, model.init(0, device="cpu"), prompts, mesh=mesh)


@pytest.mark.parametrize("family", ["lm", "encdec"])
def test_decode_multi_passes_moe_impl_through(family):
    """``decode_multi(moe_impl=)`` reaches every step without a ``TpCtx``:
    a tiny Qwen3-MoE window under 'ep' equals its 'ep' steps one by one;
    the enc-dec decoder, whose decode takes no ``moe_impl``, refuses it."""
    if family == "encdec":
        model = R.build_model(R.get_tiny("seamless-m4t-large-v2"))
        with pytest.raises(TypeError, match="moe_impl"):
            model.decode_multi(None, None, torch.ones((1, 1), dtype=torch.long),
                               torch.zeros(1, dtype=torch.long), 1, n_max=1, moe_impl="ep")
        return
    # capacity 1.0 drops assignments, so 'ep' and 'dense' windows part
    model = R.build_model(R.get_tiny("qwen3-moe-30b-a3b").replace(capacity_factor=1.0))
    params = model.init(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, model.cfg.vocab_size, (B, S0), generator=g)
    cache, outs = model.prefill(params, toks, cache_len=S0 + 3, moe_impl="ep")
    tok0, pos0 = outs["final"]["label"].reshape(B, 1).long(), torch.full((B,), S0)
    c1 = R.tree_map(torch.clone, cache)
    _, (_, _, fl, ex, nd) = model.decode_multi(params, c1, tok0, pos0, 3, n_max=3,
                                               moe_impl="ep")
    assert int(nd) == 3
    tok, pos = tok0, pos0
    for i in range(3):
        cache, o = model.decode(params, cache, tok, pos, moe_impl="ep")
        np.testing.assert_array_equal(fl[i].numpy(), o["final"]["label"].reshape(-1).numpy())
        tok, pos = o["final"]["label"].reshape(B, 1).long(), pos + 1
    for a, b in zip(R.tree_leaves(c1), R.tree_leaves(cache)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    c2 = R.tree_map(torch.clone, c1)
    model.decode_multi(params, c2, tok0, pos0, 3, n_max=3, moe_impl="dense")
    assert not all(torch.equal(a, b) for a, b in zip(R.tree_leaves(c1), R.tree_leaves(c2)))
