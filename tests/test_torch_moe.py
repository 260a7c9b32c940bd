"""The port's dense MoE against the JAX package's on tiny DeepSeek-V2-Lite
shapes: the same (bridged) weights and inputs, fp32. Output and aux loss
within 1e-5; expert ids from ``torch.topk`` exactly ``jax.lax.top_k``'s,
except at a near-tie between router probabilities, which the test flags."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_tiny  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.common import is_info  # noqa: E402
from repro.models.layers import TEST_AXES  # noqa: E402
from repro_torch.configs import get_tiny as port_tiny  # noqa: E402  # repro: allow[tier1-deps] — the port under test; torch-only, skipped above without torch
from repro_torch.models import moe as port_moe  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.bridge import from_numpy_params  # noqa: E402  # repro: allow[tier1-deps] — the port under test
from repro_torch.models.common import tree_leaves  # noqa: E402  # repro: allow[tier1-deps] — the port under test

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite-16b"
TIE = 1e-6  # router probabilities closer than this may order either way


def _params(cfg, seed):
    """Reference MoE params drawn from a seed, perturbed so every leaf,
    the router included, is far from its init scale."""
    rng = np.random.default_rng(seed)
    sch = ref_moe.moe_schema(cfg)
    return jax.tree.map(lambda i: 0.3 * rng.standard_normal(i.shape).astype(np.float32), sch,
                        is_leaf=is_info)


def test_schema_paths_and_shapes_equal_reference():
    cfg, tcfg = get_tiny(ARCH), port_tiny(ARCH)
    ref = jax.tree.leaves(ref_moe.moe_schema(cfg, L=2), is_leaf=is_info)
    port = tree_leaves(port_moe.moe_schema(tcfg, L=2))
    assert [tuple(i.shape) for i in ref] == [tuple(i.shape) for i in port]
    assert [np.dtype(i.dtype).name for i in ref] == [str(i.dtype)[6:] for i in port]


@pytest.mark.parametrize("shape", [(2, 5), (8, 1)])  # a prefill and a decode batch
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_dense_matches_reference(shape, seed):
    cfg = get_tiny(ARCH)
    p = _params(cfg, seed)
    x = np.random.default_rng(seed + 10).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    y_ref, aux_ref = ref_moe.moe_apply(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                       TEST_AXES, impl="dense")
    tp = from_numpy_params(p, "cpu")
    y, aux = port_moe.moe_apply_dense(port_tiny(ARCH), tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), **TOL)
    # the routing itself: gates within 1e-5, expert ids exact
    x2 = x.reshape(-1, cfg.d_model)
    g_ref, i_ref, pr_ref = ref_moe._router(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x2))
    g, i, pr = port_moe._router(port_tiny(ARCH), tp, torch.from_numpy(x2))
    np.testing.assert_allclose(pr.numpy(), np.asarray(pr_ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **TOL)
    i, i_ref, probs = i.numpy(), np.asarray(i_ref), np.asarray(pr_ref)
    for t in np.nonzero((i != i_ref).any(axis=1))[0]:
        # ids may differ only where two of the top k + 1 probabilities tie
        top = np.sort(probs[t])[::-1][: cfg.top_k + 1]
        assert np.abs(np.diff(top)).min() < TIE, f"token {t}: expert ids {i[t]} vs {i_ref[t]}"
        print(f"token {t}: expert ids differ at a router near-tie")


def test_router_orders_exact_ties_as_lax_top_k():
    """Exactly equal router probabilities: the port's router, like
    ``jax.lax.top_k``, takes the lower expert id first (``torch.topk`` does
    not on the CPU)."""
    cfg = get_tiny(ARCH)
    x = np.zeros((3, cfg.d_model), np.float32)
    x[1, 0] = 1.0
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0, 1:] = 2.0  # token 1: experts 1..E-1 tie above expert 0; tokens 0, 2: all tie
    p = {"router": router}
    _, i_ref, _ = ref_moe._router(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _, i, _ = port_moe._router(port_tiny(ARCH), from_numpy_params(p, "cpu"), torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i.numpy(), [[0, 1], [1, 2], [0, 1]])


@pytest.mark.parametrize("shape", [(2, 5), (8, 1)])
def test_moe_dense_equals_reference_ep_dispatch_without_drops(shape):
    """Every MoE layer of the port runs the dense dispatch. Where the
    reference's default capacity-dropping dispatch keeps every token (a
    capacity of all T tokens per expert), the two agree within 1e-5: they
    differ only in the drops, which the port does not make."""
    cfg = get_tiny(ARCH)
    cfg = cfg.replace(capacity_factor=float(cfg.n_experts) / cfg.top_k)
    p = _params(cfg, 2)
    x = np.random.default_rng(12).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    y_ref, aux_ref = ref_moe.moe_apply(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                       TEST_AXES)
    y, aux = port_moe.moe_apply_dense(port_tiny(ARCH), from_numpy_params(p, "cpu"),
                                      torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_ref), **TOL)
