"""Port vs reference: the §4.4 sequence estimator (``core/estimator.py``).

Both packages get the same shapes.  ``time_ours``, ``storage_ours``,
``storage_naive``, ``layer_shapes_for_batch`` and ``choose_order`` (the
'ours' dataflow) are exactly equal.  ``time_naive`` is the one deliberate
difference: the port gives back the ``b·c`` loss-error transpose that the
reference drops (ROADMAP Queue 3), so the port's naive price is the
reference's plus exactly ``b·c``, naive never prices below ours, and the
chosen order is the reference's for every shape.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis",
                    reason="property tests need hypothesis "
                           "(pip install -e .[test])")
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro.core import estimator as ref  # noqa: E402
from repro_torch.core import estimator as port  # noqa: E402

ORDERS = ("coag", "agco")
# every product stays far below 2**53, so float sums are exact integers
SHAPES = dict(b=st.integers(1, 4096), n=st.integers(1, 1 << 16),
              nbar=st.integers(1, 1 << 18), d=st.integers(1, 1024),
              h=st.integers(1, 1024), e=st.integers(1, 1 << 22),
              c=st.integers(0, 200))


def _shapes(b, n, nbar, d, h, e, c):
    return (ref.LayerShape(b=b, n=n, nbar=nbar, d=d, h=h, e=e, c=c),
            port.LayerShape(b=b, n=n, nbar=nbar, d=d, h=h, e=e, c=c))


@settings(max_examples=60, deadline=None)
@given(**SHAPES)
def test_estimator_prices_ours_equal_the_reference(b, n, nbar, d, h, e, c):
    rs, ps = _shapes(b, n, nbar, d, h, e, c)
    for order in ORDERS:
        assert port.time_ours(ps, order) == ref.time_ours(rs, order)
        assert port.storage_ours(ps, order) == ref.storage_ours(rs, order)
        assert port.storage_naive(ps, order) == ref.storage_naive(rs, order)
    got, want = port.choose_order(ps, "ours"), ref.choose_order(rs, "ours")
    assert (got.order, got.time, got.storage) == (want.order, want.time,
                                                  want.storage)


@settings(max_examples=60, deadline=None)
@given(**SHAPES)
@example(b=8, n=8, nbar=8, d=8, h=8, e=1, c=9)     # the reference's draw
@example(b=8, n=8, nbar=8, d=8, h=8, e=1, c=100)   # ROADMAP Queue 3
def test_time_naive_restores_the_loss_transpose_queue3_fault(
        b, n, nbar, d, h, e, c):
    """ROADMAP Queue 3: the reference's ``time_naive`` drops ``b·c``.  The
    port adds it back: exactly ``b·c`` above the reference, the same
    chosen order and storage, and naive above ours for both orders (the
    reference's ``test_eqs_5_to_8_ours_never_worse`` fails on the first
    example)."""
    rs, ps = _shapes(b, n, nbar, d, h, e, c)
    for order in ORDERS:
        assert port.time_naive(ps, order) - ref.time_naive(rs, order) \
            == b * c
        assert port.time_naive(ps, order) > port.time_ours(ps, order)
        assert port.storage_naive(ps, order) > port.storage_ours(ps, order)
    got, want = port.choose_order(ps, "naive"), ref.choose_order(rs, "naive")
    assert got.order == want.order
    assert got.storage == want.storage
    assert got.time - want.time == b * c


@pytest.mark.parametrize("c", [9, 100])
def test_queue3_draw_prices_naive_above_ours_only_in_the_port(c):
    """At ``b=n=nbar=d=h=8, e=1`` the reference prices naive at ours
    (c = 9: ``b·c = n̄·(e + d)``) or below it (c = 100); the port's naive
    stays above."""
    rs, ps = _shapes(8, 8, 8, 8, 8, 1, c)
    for order in ORDERS:
        assert ref.time_naive(rs, order) <= ref.time_ours(rs, order)
        assert port.time_naive(ps, order) > port.time_ours(ps, order)


@pytest.mark.parametrize("args", [
    (1024, (10, 25), 602, 256, 41, 99.6),     # gcn-reddit, the paper's setup
    (1024, (10, 25), 500, 256, 7, 10.1),      # gcn-flickr
    (512, (25, 10), 300, 128, 100, 9.7),
    (64, (3,), 16, 16, 5, 2.0),
    (32, (5, 5, 5), 8, 4, 3, 40.0),
])
def test_layer_shapes_for_batch_equal_the_reference(args):
    got = port.layer_shapes_for_batch(*args)
    want = ref.layer_shapes_for_batch(*args)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    for dataflow in ("ours", "naive"):
        assert [port.choose_order(s, dataflow).order for s in got] \
            == [ref.choose_order(s, dataflow).order for s in want]


def test_order_choice_flips_with_shape():
    """The reference's §4.4 pair: CoAg pays e·h, AgCo e·d on the edges."""
    skinny = port.LayerShape(b=512, n=512, nbar=13000, d=602, h=256,
                             e=14_000, c=41)
    wide_in = port.LayerShape(b=512, n=512, nbar=2000, d=602, h=41,
                              e=500_000, c=41)
    assert port.choose_order(skinny).order == "agco"
    assert port.choose_order(wide_in).order == "coag"
