"""The port's paged serving path against the JAX package's: the paged decode
plain version against the JAX ref and the Pallas kernel in interpret mode
(fp32, 1e-5), the copied host allocator classes, the LM's paged decode, and
paired runner schedules and engine runs with prefix sharing, copy-on-write,
swap preemption and chunked prefill.

Tolerance rule for records: labels exact, floats within 1e-4. Allocator
state and ``kv_stats()`` must agree exactly after every runner call. Pools
are compared outside block 0, the trash block: a padding row whose stale
pos lies past its table writes there in the port, while the reference
drops that write. Geometry: ``kv_block_size`` 4 divides ``prompt_len +
max_new`` (14 + 10), and ``prompt_len % 4 != 0`` keeps a partial tail
block, shared and then copied on write."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as RC  # noqa: E402
import repro.serving as RS  # noqa: E402
import repro.serving.runner as ref_runner  # noqa: E402
from repro.configs import get_tiny  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged  # noqa: E402
from repro.kernels.decode_attention import paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.core as TC  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
import repro_torch.serving as TS  # noqa: E402  # repro: allow[tier1-deps] — the port under test
import repro_torch.serving.runner as port_runner  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.kernels.decode_attention import (  # noqa: E402  # repro: allow[tier1-deps] — the port under test
    attend_decode_paged,
    paged_decode_attention_ref,
)
from repro_torch.models import build_model  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params, to_numpy  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)  # one attention call
REC_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model records and pools
P_LEN, MAX_NEW, BS = 14, 10, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the plain version ----------------------------------------------------------


def _paged_case(bs, seed):
    """A shuffled table over a pool whose block 0 is trash; row 1 owns two
    blocks and points the rest at block 0; pos covers a partial last block,
    both sides of a block boundary and the table's end."""
    rng = np.random.default_rng(seed)
    B, H, KH, hd, nb = 4, 4, 2, 16, 3
    P = B * nb + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, bs, KH, hd)).astype(np.float32)
    v = rng.standard_normal((P, bs, KH, hd)).astype(np.float32)
    table = (rng.permutation(P - 1) + 1).reshape(B, nb).astype(np.int32)
    table[1, 2:] = 0
    pos = np.array([nb * bs - 2, 2 * bs - 1, bs, nb * bs - 1], np.int32)
    return q, k, v, table, pos


@pytest.mark.parametrize("bs", [4, 16])
def test_paged_ref_matches_jax_ref(bs):
    q, k, v, table, pos = _paged_case(bs, bs)
    ref = jax_paged_ref(*(jnp.asarray(a) for a in (q, k, v, table, pos)))
    out = paged_decode_attention_ref(_t(q), _t(k), _t(v), _t(table), _t(pos.astype(np.int64)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    same = attend_decode_paged(_t(q), _t(k), _t(v), _t(table), _t(pos))  # CPU -> plain
    np.testing.assert_array_equal(same.numpy(), out.numpy())


def test_paged_ref_matches_pallas_interpret():
    q, k, v, table, pos = _paged_case(4, 7)
    got = pallas_paged(*(jnp.asarray(a) for a in (q, k, v, table, pos)), interpret=True)
    out = paged_decode_attention_ref(_t(q), _t(k), _t(v), _t(table), _t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(got), **TOL)


def test_no_paged_kernel_for_other_devices():
    z = torch.zeros(2, 4, 64, device="meta")
    pool = torch.zeros(3, 4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        attend_decode_paged(z, pool, pool, torch.zeros(2, 2, dtype=torch.int32), 3)


# -- the copied host classes ----------------------------------------------------


@pytest.mark.parametrize("name", ["BlockAllocator", "PrefixCache"])
def test_allocator_class_is_a_verbatim_copy(name):
    assert inspect.getsource(getattr(port_runner, name)) == \
        inspect.getsource(getattr(ref_runner, name))


def _alloc_state(al):
    return (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(), sorted(al._free),
            al.n_free, al.pins, al.peak_blocks)


def test_allocator_random_schedule_agrees():
    """Seeded alloc / share / cow / pin / unpin / release_tail / free_slot
    and prefix-cache register / lookup / evict_for through both copies:
    equal state after every operation, and equal PoolExhausted refusals."""
    rng = np.random.default_rng(5)
    stacks = []
    for mod in (ref_runner, port_runner):
        al = mod.BlockAllocator(12, 6, 4)
        stacks.append((mod, al, mod.PrefixCache(al, 3)))
    ops = {"refused": 0, "done": 0}
    toks = rng.integers(0, 4, (6, 10))
    for _ in range(300):
        op = str(rng.choice(["alloc", "share", "cow", "pin", "tail", "free", "reg", "evict"]))
        slot = int(rng.integers(4))
        n = int(rng.integers(1, 4))
        item = int(rng.integers(6))
        res = []
        for mod, al, pc in stacks:
            try:
                if op == "alloc":
                    al.alloc(slot, n)
                elif op == "share":
                    live = [b for b in range(1, al.n_blocks + 1) if al.refcount[b] > 0]
                    al.share(slot, live[:n] if live else [])
                elif op == "cow" and al.owned[slot]:
                    al.cow(slot, int(al.owned[slot]) - 1)
                elif op == "pin":
                    live = [b for b in range(1, al.n_blocks + 1) if al.refcount[b] > 0]
                    if live:
                        al.pin(live[0])
                elif op == "tail":
                    al.release_tail(slot, max(int(al.owned[slot]) - n, 0))
                elif op == "free":
                    al.free_slot(slot)
                elif op == "reg" and al.owned[slot] * 3 >= 10:
                    pc.register(toks[item], al.owned_ids(slot), item)
                elif op == "evict":
                    pc.evict_for(n + 2)
                res.append(("ok", pc.lookup(toks[item])))
            except (mod.PoolExhausted, ValueError) as e:
                res.append((type(e).__name__, None))
        assert res[0] == res[1], (op, res)
        assert _alloc_state(stacks[0][1]) == _alloc_state(stacks[1][1]), op
        ops["refused" if res[0][0] != "ok" else "done"] += 1
    assert ops["refused"] > 0 and ops["done"] > 100, ops


# -- the LM's paged decode --------------------------------------------------------


def _lm_pair(arch, seed=0):
    rm = ref_build(get_tiny(arch).replace(decode_attn="paged"))
    tm = build_model(port_tiny(arch).replace(decode_attn="paged-kernel", pallas_head="kernel"))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    return rm, jax.tree.map(jnp.asarray, p), tm, from_numpy_params(p, "cpu"), rng


def _pools(rm, rng, P):
    """Random pool contents, (L, P, bs, KH, hd) per leaf, for both models."""
    sch = rm.paged_cache_schema(P, BS)
    ref = jax.tree.map(lambda i: rng.standard_normal(i.shape).astype(np.float32), sch,
                       is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))
    return jax.tree.map(jnp.asarray, ref), from_numpy_params(ref, "cpu")


def _same_pools(tc, rc):
    """Pools agree outside the trash block 0."""
    for a, b in zip(jax.tree.leaves(to_numpy(tc)), jax.tree.leaves(rc)):
        np.testing.assert_allclose(a[:, 1:], np.asarray(b)[:, 1:], **REC_TOL)


LIVE = [0, 1, 3]  # the padding row's outputs are garbage in both packages


def _check_stats(t, r, keys):
    for k in keys:
        a, b = t[k].numpy()[..., LIVE], np.asarray(r[k]).reshape(t[k].shape)[..., LIVE]
        if k in ("label", "exit"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **REC_TOL)


def _decode_inputs(rm, rng):
    """Rows: two live rows, a FREE padding row (table of zeros, a stale pos
    past its table: the port writes it to the trash block, the reference
    drops it) and a duplicate of row 0."""
    nb, P = 6, 13
    table = (rng.permutation(P - 1) + 1)[: 2 * nb].reshape(2, nb).astype(np.int32)
    table = np.concatenate([table, np.zeros((1, nb), np.int32), table[:1]])
    pos = np.array([9, 14, nb * BS + 3, 9], np.int32)
    tok = rng.integers(0, rm.cfg.vocab_size, (4, 1)).astype(np.int32)
    return P, table, pos, tok


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gpt2-medium"])
def test_lm_paged_decode_matches_reference(arch):
    rm, rp, tm, tp, rng = _lm_pair(arch)
    P, table, pos, tok = _decode_inputs(rm, rng)
    rc, tc = _pools(rm, rng, P)
    act = list(range(len(rm.sites)))
    thr = np.full(len(act), 0.999, np.float32)
    rc, ro = rm.decode(rp, rc, jnp.asarray(tok), jnp.asarray(pos),
                       active_sites=jnp.asarray(act, jnp.int32), block_tables=jnp.asarray(table),
                       exit_thresholds=jnp.asarray(thr))
    tc, to = tm.decode(tp, tc, _t(tok).long(), _t(pos), active_sites=act,
                       block_tables=_t(table), exit_thresholds=_t(thr))
    _check_stats(to["final"], ro["final"], ("label", "maxprob", "entropy"))
    _check_stats(to["ramps"], ro["ramps"], ("label", "maxprob", "entropy", "exit"))
    _same_pools(tc, rc)
    with pytest.raises(ValueError):  # paged decode needs per-row positions
        tm.decode(tp, tc, _t(tok).long(), torch.tensor(3), block_tables=_t(table))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gpt2-medium"])
@pytest.mark.parametrize("thr_kind", ["mid", "all_exit"])
def test_lm_paged_decode_multi_window(arch, thr_kind):
    """A sync window on the pool: records up to n_done, and past n_done the
    pool is unchanged (the port's gated writes against the reference's
    stopped loop)."""
    rm, rp, tm, tp, rng = _lm_pair(arch, seed=1)
    P, table, pos, tok = _decode_inputs(rm, rng)
    rc, tc = _pools(rm, rng, P)
    act = list(range(len(rm.sites)))
    thr = (np.ones(len(act), np.float32) if thr_kind == "all_exit"
           else np.full(len(act), 0.9, np.float32))
    valid = np.array([True, True, False, False])
    n, n_max = 3, 4
    rc, (rl, rmp, fl, ex, nd) = rm.decode_multi(
        rp, rc, jnp.asarray(tok), jnp.asarray(pos), n, n_max=n_max,
        active_sites=jnp.asarray(act, jnp.int32), thresholds=jnp.asarray(thr),
        row_valid=jnp.asarray(valid), block_tables=jnp.asarray(table))
    tc, (tl, tmp, tfl, tex, tnd) = tm.decode_multi(
        tp, tc, _t(tok).long(), _t(pos), n, n_max=n_max, active_sites=act,
        thresholds=_t(thr), row_valid=_t(valid), block_tables=_t(table))
    nd = int(nd)
    assert int(tnd) == nd
    if thr_kind == "all_exit":
        assert nd == 1
    np.testing.assert_array_equal(tl.numpy()[:nd, :, LIVE], np.asarray(rl)[:nd, :, LIVE])
    np.testing.assert_allclose(tmp.numpy()[:nd, :, LIVE], np.asarray(rmp)[:nd, :, LIVE],
                               **REC_TOL)
    np.testing.assert_array_equal(tfl.numpy()[:nd, LIVE], np.asarray(fl)[:nd, LIVE])
    np.testing.assert_array_equal(tex.numpy()[:nd, LIVE], np.asarray(ex)[:nd, LIVE])
    _same_pools(tc, rc)


# -- paired runner schedules ------------------------------------------------------


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, 512, (n, P_LEN))
    prompts[1] = prompts[0]  # a whole-prompt hit (its partial tail block included)
    prompts[2, :8] = prompts[0, :8]  # a partial hit: two shared blocks
    prompts[5] = prompts[3]
    return prompts


def _runner_pair(paged, prompts, seed=0, **kw):
    rm = ref_build(get_tiny("qwen2-1.5b").replace(decode_attn="paged" if paged else "ref"))
    tm = build_model(port_tiny("qwen2-1.5b").replace(
        decode_attn="paged-kernel" if paged else "kernel", pallas_head="kernel"))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        rm.init(jax.random.PRNGKey(seed)))
    kw = {"max_new_tokens": MAX_NEW, "max_slots": 2, "n_slots": 4, **kw}
    if paged:
        kw["kv_block_size"] = BS
    return (rm, RS.DecodeRunner(rm, jax.tree.map(jnp.asarray, p), prompts, **kw),
            TS.DecodeRunner(tm, from_numpy_params(p, "cpu"), prompts, **kw))


def _runner_state(r):
    out = {"pos": r._pos.tolist(), "tok": r._tok.tolist(), "live": sorted(r._live),
           "pf": dict(r._pf_progress), "kv": r.kv_stats()}
    if r._alloc is not None:
        al = r._alloc
        out["alloc"] = (al.table.tolist(), al.owned.tolist(), al.refcount.tolist(),
                        al.n_free, al.peak_blocks, al.pins)
    return out


class _Both:
    """Apply one call to the reference and the port runner, then hold the
    results to the tolerance rule and the states to exact equality."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port
        self.seen = set()

    def __call__(self, name, *args, port_args=None):
        outs = []
        for r, a, exc in ((self.ref, args, RS.PoolExhausted),
                          (self.port, port_args or args, TS.PoolExhausted)):
            try:
                outs.append(("ok", getattr(r, name)(*a)))
            except exc:
                outs.append(("exhausted", None))
        (kr, rr), (kt, rt) = outs
        assert kr == kt, (name, args, kr, kt)
        self.seen.add(name if kr == "ok" else f"{name}:exhausted")
        if kr == "ok" and isinstance(rr, tuple):
            for i, (a, b) in enumerate(zip(rt, rr)):
                if np.asarray(a).dtype.kind == "f":
                    np.testing.assert_allclose(a, b, **REC_TOL)
                else:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} record {i}")
        elif kr == "ok" and name != "swap_out":
            assert rt == rr, (name, rt, rr)
        assert _runner_state(self.port) == _runner_state(self.ref), name
        return rr, rt


def test_paged_runner_schedule_agrees():
    """Admits (private, whole-prompt hit, partial hit), steps, sync windows
    with early ends, a CoW of the shared tail block, a swap round trip,
    PoolExhausted with an atomic unwind, chunked prefill and frees, then
    a seeded random tail; the pools agree outside block 0 at the end."""
    prompts = _prompts(8, 3)
    rm, ref, port = _runner_pair(True, prompts, kv_blocks=11, prefix_cache=True)
    both = _Both(ref, port)
    act = [0, 1]
    thr = np.array([0.5, 0.9], np.float32)
    both("start", 0, 0)
    both("start", 1, 1)  # whole prompt cached: no device work
    both("start", 2, 2)  # two blocks shared, the rest prefilled
    both("step", [0, 1, 2], act)  # slot 1 appends into its shared tail: CoW
    both("step_multi", [0, 1, 2], act, 3, thr)
    both("step_multi", [0, 2], act, 2, np.ones(2, np.float32))  # ends after one step
    (h_ref, h_port) = both("swap_out", 1)
    both("start", 3, 3)  # the pool runs dry mid-admission
    both("free", 2)
    both("swap_in", 2, h_ref, port_args=(2, h_port))
    both("step_multi", [0, 2], act, 4, thr)  # needs more blocks than are free
    both("free", 0)
    both("prefill_begin", 0, 4, 6)
    both("prefill_resume", 0, 3)
    both("prefill_resume", 0, 8)
    both("step", [0, 2], [])
    rng = np.random.default_rng(4)
    item = 5
    for _ in range(12):
        live = sorted(ref._live - set(ref._pf_progress))
        free = [s for s in range(4) if s not in ref._live]
        op = str(rng.choice(["start", "multi", "free"], p=[0.3, 0.5, 0.2]))
        if op == "start" and free and item < len(prompts):
            both("start", int(free[0]), item)
            item += 1
        elif op == "free" and live:
            both("free", int(rng.choice(live)))
        else:
            ok = [s for s in live if ref._pos[s] < P_LEN + MAX_NEW - 4]
            if ok:
                both("step_multi", ok, act, int(rng.integers(1, 4)), thr)
    assert {"start", "step", "step_multi", "swap_out", "swap_in", "free", "prefill_begin",
            "prefill_resume", "start:exhausted", "step_multi:exhausted"} <= both.seen, both.seen
    kv = port.kv_stats()
    assert kv["prefix_hits"] >= 2 and kv["cow_copies"] >= 1 and kv["swap_ins"] == 1
    _same_pools(port._cache, ref._cache)


def test_auto_sized_pool_grows_with_rows():
    """kv_blocks=None sizes the pool to full slot capacity: starting a slot
    past the rows grows the table and copies the pool along its axis."""
    prompts = _prompts(6, 9)
    _, ref, port = _runner_pair(True, prompts, n_slots=1)
    both = _Both(ref, port)
    both("start", 0, 3)
    both("step", [0], [0])
    both("start", 2, 4)  # rows 1 -> 4, pool 6 -> 24 blocks
    assert port.kv_stats()["n_blocks"] == 24
    both("step_multi", [0, 2], [0, 1], 2, np.array([0.5, 0.9], np.float32))
    _same_pools(port._cache, ref._cache)


def test_contiguous_chunked_prefill_agrees():
    """Chunked prefill on the contiguous layout, interleaved with decode
    steps of another slot; a mid-prefill slot cannot be stepped."""
    prompts = _prompts(6, 6)
    _, ref, port = _runner_pair(False, prompts, seed=1)
    both = _Both(ref, port)
    both("start", 0, 0)
    assert both("prefill_begin", 1, 3, 5) == (None, None)
    with pytest.raises(KeyError):
        port.step([0, 1], [0])
    both("step", [0], [0])
    both("prefill_resume", 1, 4)
    both("step_multi", [0], [0], 2, np.array([0.9], np.float32))
    both("prefill_resume", 1, 20)
    both("step", [0, 1], [0, 1])
    both("prefill_begin", 2, 2, P_LEN)  # a whole-prompt first chunk is a start


# -- the whole engine ---------------------------------------------------------------


def test_engine_prefix_swap_chunked_agrees():
    """GenerativeEngine with a prefix cache, swap preemption and chunked
    prefill over a pool too small for every stream: equal responses and
    equal engine counters, with prefix hits and swaps both taking place."""
    prompts = _prompts(8, 8)
    rm, _, _ = _runner_pair(True, prompts)
    prof = RC.build_profile(get_tiny("qwen2-1.5b"), mode="decode", chips=1, sites=rm.sites,
                            charge_kv=True)
    n, toks = 8, 7
    arr = RS.maf_trace(n, mean_qps=RS.offered_decode_qps(
        prof, max_batch_size=4, tokens_per_request=toks, load=2.0), seed=3)
    out = {}
    _, ref, port = _runner_pair(True, prompts, seed=2, kv_blocks=11, prefix_cache=True)
    for name, S, C, runner in (("ref", RS, RC, ref), ("port", TS, TC, port)):
        reqs = S.make_gen_requests(arr, n_tokens=toks, prompt_len=P_LEN,
                                   slo_ms=3 * prof.vanilla_time(1))
        ctl = C.ApparateController(len(rm.sites), prof, C.ControllerConfig(
            max_slots=2, ramp_budget_frac=0.6))
        eng = S.GenerativeEngine(prof, S.GenerativeConfig(
            max_batch_size=4, steps_per_sync=3, prefill_chunk=6, preempt="swap"), runner, ctl)
        out[name] = (eng.run(reqs), eng.stats(), runner.kv_stats())
    (rr, rstat, rkv), (tr, tstat, tkv) = out["ref"], out["port"]
    assert len(tr) == len(rr) == n
    for a, b in zip(tr, rr):
        assert (a.rid, a.tokens, a.final_tokens, a.exit_sites, a.shed, a.dropped) == (
            b.rid, b.tokens, b.final_tokens, b.exit_sites, b.shed, b.dropped)
        np.testing.assert_array_equal(a.release_ms, b.release_ms)
    assert tstat == rstat and tkv == rkv
    assert tkv["prefix_hits"] > 0 and tstat["preempt_swaps"] > 0, (tkv, tstat)


# -- the launcher ----------------------------------------------------------------------


def test_serve_flags_require_paged():
    from repro_torch.launch.serve import main, serve_generative  # repro: allow[tier1-deps] — the port under test

    with pytest.raises(ValueError):
        serve_generative("gpt2-medium", 2, prefix_cache=True, tiny=True, device="cpu")
    with pytest.raises(ValueError):
        serve_generative("gpt2-medium", 2, preempt="swap", tiny=True, device="cpu")
    with pytest.raises(SystemExit):
        main(["--preempt", "later"])
    tm = build_model(port_tiny("qwen2-1.5b").replace(decode_attn="kernel"))
    with pytest.raises(ValueError):  # the runner-level form of the same contract
        TS.DecodeRunner(tm, {"tok": {"embed": torch.zeros(1)}}, np.zeros((1, 4), np.int32),
                        prefix_cache=True)


def test_serve_launcher_paged_on_cpu_tiny():
    """The launcher's paged path end to end at tiny size: requests complete,
    and the output reports the pool's kv_stats."""
    from repro_torch.launch.serve import serve_generative  # repro: allow[tier1-deps] — the port under test

    out, resp = serve_generative("qwen2-1.5b", 4, decode_tokens=5, prompt_len=8,
                                 steps_per_sync=3, tiny=True, device="cpu", verbose=False,
                                 kv_block_size=4, kv_blocks=9, prefix_cache=True,
                                 preempt="swap", prefill_chunk=3)
    assert len(resp) == 4 and all(len(r.tokens) == 5 and not r.dropped for r in resp)
    kv = out["kv_cache"]
    assert kv["paged"] and kv["block_size"] == 4 and kv["n_blocks"] == 9
    assert out["decode_attn"] == "paged-kernel" and out["measured"]["prefill_chunk_calls"] > 0
