"""The port's host planner against ``repro.core.affected``.

``build_plan`` + ``pack_plan`` must give the reference's
``pack_plan(pallas=False)`` buffers bitwise — idx, flt, msk, feat_vals and
the layout — over gcn (unconstrained) and gat (constrained) streams, with
capacity hysteresis on both sides.  The port's own row schedules must sum
every live record exactly once, into its own row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.affected import BucketHysteresis as JHysteresis  # noqa: E402
from repro.core.affected import build_plan as j_build_plan  # noqa: E402
from repro.core.affected import pack_plan as j_pack_plan  # noqa: E402
from repro.core.models import make_model as j_make_model  # noqa: E402
from repro.graph import make_graph as j_make_graph  # noqa: E402
from repro.graph import make_stream as j_make_stream  # noqa: E402
from repro_torch.core.affected import (  # noqa: E402
    BucketHysteresis,
    build_plan,
    layout_slices,
    pack_plan,
    sched_slices,
)
from repro_torch.core.models import make_model  # noqa: E402
from repro_torch.graph import make_graph, make_stream  # noqa: E402

STREAM = dict(num_batches=12, batch_edges=8, delete_frac=0.35, seed=3,
              feature_dim=8, feature_frac=0.02)


def _streams():
    kw = dict(avg_degree=5, seed=2, weighted=True)
    return (make_stream(make_graph("powerlaw", 120, **kw), **STREAM),
            j_make_stream(j_make_graph("powerlaw", 120, **kw), **STREAM))


def _packed_pairs(name):
    """(port PackedPlan, reference PackedPlan) for every batch of a stream."""
    wl, jwl = _streams()
    model, jmodel = make_model(name), j_make_model(name)
    hwm, jhwm = BucketHysteresis(), JHysteresis()
    g, jg = wl.base, jwl.base
    for b, jb in zip(wl.batches, jwl.batches):
        g2 = g.apply_updates(b.ins_src, b.ins_dst, b.del_src, b.del_dst,
                             b.ins_weights, b.ins_etypes)
        jg2 = jg.apply_updates(jb.ins_src, jb.ins_dst, jb.del_src, jb.del_dst,
                               jb.ins_weights, jb.ins_etypes)
        p = pack_plan(build_plan(model, g, g2, b, 2), b.feat_vertices, b.feat_values, hwm=hwm)
        jp = j_pack_plan(j_build_plan(jmodel, jg, jg2, jb, 2), jb.feat_vertices,
                         jb.feat_values, pallas=False, hwm=jhwm)
        yield p, jp
        g, jg = g2, jg2


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_packed_buffers_bitwise_equal_reference(name):
    for p, jp in _packed_pairs(name):
        assert p.layout.n == jp.layout.n
        assert p.layout.feat_cap == jp.layout.feat_cap
        assert p.layout.caps == jp.layout.caps
        for field in ("idx", "flt", "msk"):
            a, b = getattr(p, field), getattr(jp, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        if jp.feat_vals is None:
            assert p.feat_vals is None
        else:
            np.testing.assert_array_equal(p.feat_vals, jp.feat_vals)
        np.testing.assert_array_equal(p.out_rows_final, jp.out_rows_final)
        assert (p.n_inc_edges, p.n_full_edges, p.n_out_rows) == \
            (jp.n_inc_edges, jp.n_full_edges, jp.n_out_rows)


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_row_schedule_sums_each_record_exactly_once(name):
    checked = 0
    for p, _ in _packed_pairs(name):
        idx_sl, _, msk_sl, _ = layout_slices(p.layout)
        s_sl, s_len = sched_slices(p.layout)
        assert p.sched.shape == (s_len,) and p.sched.dtype == np.int32
        for l in range(len(p.layout.caps)):
            for kind, rowidx, mask in (("e", "e_rowidx", "e_mask"), ("f", "f_rowidx", "f_emask")):
                rows = p.idx[idx_sl[l][rowidx]]
                live = p.msk[msk_sl[l][mask]]
                order = p.sched[s_sl[l][f"{kind}_order"]]
                row_ptr = p.sched[s_sl[l][f"{kind}_row_ptr"]]
                assert row_ptr[0] == 0 and row_ptr[-1] == live.sum()
                # every live record once, no padded record
                np.testing.assert_array_equal(np.sort(order[: row_ptr[-1]]), np.nonzero(live)[0])
                for r in range(row_ptr.shape[0] - 1):
                    run = order[row_ptr[r]:row_ptr[r + 1]]
                    assert np.all(rows[run] == r)
                checked += int(live.sum())
    assert checked > 0
