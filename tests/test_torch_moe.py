"""Port vs reference: the MoE FFN's pieces (``repro.models.moe``) on the
same numpy inputs.

* ``capacity`` equals the reference's over a grid that includes the
  shapes where its formula covers under 90% of the load (ROADMAP Queue
  3: parity keeps that reference fault);
* ``top_k`` takes the lower expert first on exact ties, as
  ``jax.lax.top_k``; routing with every logit tied picks experts 0..k-1;
* ``_positions``, the dispatch, the expert products and the gated combine
  within 1e-5 of ``moe_ffn``, with slots dropped at a small capacity
  factor, and the aux loss within 1e-6; ``drop_fraction`` counts the
  reference plan's dropped slots;
* ``moe_ffn(ep_spec=...)`` raises, naming the multi-GPU item.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402

FFN_TOL, AUX_TOL = 1e-5, 1e-6
# (tokens, experts, topk, factor) where int(factor·tokens·topk/experts)
# falls in (80/9, 9): capacity 8 covers under 90% of the load
UNDER_COVERED = [(143, 16, 1, 1.0), (107, 12, 1, 1.0), (89, 10, 1, 1.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("topk", [1, 2, 6])
@pytest.mark.parametrize("experts", [2, 8, 16, 64, 128])
def test_capacity_matches_reference(experts, topk, factor):
    for tokens in (1, 7, 8, 143, 1000, 2048, 16384):
        assert moe.capacity(tokens, experts, topk, factor) \
            == ref_moe.capacity(tokens, experts, topk, factor)


@pytest.mark.parametrize("tokens,experts,topk,factor", UNDER_COVERED)
def test_capacity_keeps_the_reference_under_coverage(tokens, experts, topk,
                                                     factor):
    cap = moe.capacity(tokens, experts, topk, factor)
    assert cap == ref_moe.capacity(tokens, experts, topk, factor) == 8
    assert cap * experts < 0.9 * factor * tokens * topk


def test_top_k_takes_the_lower_index_on_exact_ties():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.1, 0.3, 0.3, 0.0, 0.3]], np.float32)
    for k in (1, 2, 3, 5):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _layer(rng, cfg, router_scale=1.0):
    """A MoE layer's FFN leaves: the reference's dict and the port's
    attribute view of the same numpy arrays."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    leaves = {
        "router": rng.standard_normal((d, e)).astype(np.float32)
        * d ** -0.5 * router_scale,
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32)
        * d ** -0.5,
        "w_up": rng.standard_normal((e, d, f)).astype(np.float32)
        * d ** -0.5,
        "w_down": rng.standard_normal((e, f, d)).astype(np.float32)
        * f ** -0.5,
    }
    ref = {k: jnp.asarray(v) for k, v in leaves.items()}
    port = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                    for k, v in leaves.items()})
    return ref, port


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_ffn_matches_reference_with_drops(arch, factor):
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    rng = np.random.default_rng(int(factor * 100) + cfg.moe_topk)
    ref_p, p = _layer(rng, cfg)
    b, s = 3, 40
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    want_y, want_aux = ref_moe.moe_ffn(jnp.asarray(x), ref_p, ref_cfg,
                                       capacity_factor=factor)
    got_y, got_aux = moe.moe_ffn(torch.from_numpy(x), p, cfg,
                                 capacity_factor=factor)
    assert got_y.shape == (b, s, cfg.d_model)
    assert float(np.abs(got_y.numpy() - np.asarray(want_y)).max()) \
        <= FFN_TOL
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL
    # the capacity plan, slot by slot, and the share of slots dropped
    _, eidx, _ = ref_moe._route(jnp.asarray(x), ref_p, ref_cfg)
    _, got_e, _ = moe._route(torch.from_numpy(x), p, cfg)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(eidx))
    cap = moe.capacity(s, cfg.moe_experts, cfg.moe_topk, factor)
    kept = []
    for i in range(b):
        flat = np.array(eidx[i]).reshape(-1)
        want_pos, want_keep = ref_moe._positions(jnp.asarray(flat),
                                                 cfg.moe_experts, cap)
        pos, keep = moe._positions(torch.from_numpy(flat), cfg.moe_experts,
                                   cap)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
        kept.append(np.asarray(want_keep))
    want_drop = 1.0 - np.concatenate(kept).mean()
    assert moe.drop_fraction(torch.from_numpy(x), p, cfg, factor) \
        == pytest.approx(want_drop, abs=1e-7)
    if factor <= 0.5:
        assert want_drop > 0            # the case drops slots


def test_moe_ffn_with_every_router_logit_tied():
    """A zero router ties every expert for every token: both take experts
    0..k-1 with equal gates, so the first k experts fill and the rest of
    each sample's slots drop the same way."""
    arch = "moonshot-v1-16b-a3b"
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    rng = np.random.default_rng(3)
    ref_p, p = _layer(rng, cfg, router_scale=0.0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    _, got_e, _ = moe._route(torch.from_numpy(x), p, cfg)
    assert (got_e.numpy() == np.arange(cfg.moe_topk)).all()
    want_y, want_aux = ref_moe.moe_ffn(jnp.asarray(x), ref_p, ref_cfg)
    got_y, got_aux = moe.moe_ffn(torch.from_numpy(x), p, cfg)
    assert float(np.abs(got_y.numpy() - np.asarray(want_y)).max()) \
        <= FFN_TOL
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


def test_ep_spec_raises():
    cfg = get_smoke("moonshot-v1-16b-a3b")
    _, p = _layer(np.random.default_rng(0), cfg)
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(NotImplementedError, match="item 10"):
        moe.moe_ffn(x, p, cfg, ep_spec=("data", "model", None))
