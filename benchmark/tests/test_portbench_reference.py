"""The plain reference against brute force in NumPy."""

import numpy as np
import pytest
import torch

from benchmark import corpus
from benchmark.reference import exact_topk

SPEC = dict(num_rows=500, num_cols=256, average_degree=12,
            distribution="gamma", l2_norm=True)


def _dense(c, values):
    a = np.zeros((c["num_rows"], c["num_cols"]), np.float64)
    v = c["vals"].numpy()
    if values == "bf16":
        bits = v.view(np.uint32)
        v = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).view(np.float32)
    np.add.at(a, (c["rows"].numpy(), c["cols"].numpy()), v.astype(np.float64))
    return a


def _query(q, query):
    q = q.astype(np.float32)
    if query == "f32":
        return q.astype(np.float64)
    lv = {"i8s": 127.0, "i4s": 7.0}[query]
    scale = (np.abs(q).max(axis=1, keepdims=True) / np.float32(lv)).astype(np.float32)
    return np.clip(np.round(q / scale), -lv, lv) * scale.astype(np.float64)


@pytest.mark.parametrize("values", ["f32", "bf16"])
@pytest.mark.parametrize("query", ["f32", "i8s", "i4s"])
def test_topk_against_brute_force(values, query):
    c = corpus.make_corpus(SPEC, 5, "cpu")
    q = corpus.make_queries(7, SPEC["num_cols"], 5, "cpu")
    a = _dense(c, values)
    want = a @ _query(q.numpy(), query).T          # (rows, 7)
    m = exact_topk.csr(c["indptr"], c["cols"], c["vals"], SPEC["num_rows"],
                       SPEC["num_cols"], values)
    rows, vals = exact_topk.topk(m, exact_topk.effective_query(q, query), 20,
                                 block=3)
    for j in range(7):
        order = np.argsort(-want[:, j], kind="stable")[:20]
        np.testing.assert_allclose(vals[j].numpy(), want[order, j], rtol=1e-12)
        # the same rows, up to exact ties
        assert set(rows[j].tolist()) == set(order.tolist()) or \
            np.allclose(np.sort(want[rows[j].numpy(), j]),
                        np.sort(want[order, j]), rtol=1e-12)


def test_judge_inputs_of_served_rows():
    c = corpus.make_corpus(SPEC, 9, "cpu")
    q = corpus.make_queries(4, SPEC["num_cols"], 9, "cpu")
    a = _dense(c, "bf16")
    want = a @ q.numpy().astype(np.float64).T
    m = exact_topk.csr(c["indptr"], c["cols"], c["vals"], SPEC["num_rows"],
                       SPEC["num_cols"], "bf16")
    served = torch.tensor([[0, 3, 499], [1, 2, -1], [7, 7, 8], [500, 4, 5]])
    of_served, kth, best = exact_topk.judge_inputs(
        m, exact_topk.effective_query(q, "f32"), served, 10, block=2)
    for j in range(4):
        for p, r in enumerate(served[j].tolist()):
            if 0 <= r < SPEC["num_rows"]:
                assert of_served[j, p] == pytest.approx(want[r, j], rel=1e-12)
            else:
                assert torch.isnan(of_served[j, p])
        s = np.sort(want[:, j])[::-1]
        assert best[j] == pytest.approx(s[0], rel=1e-12)
        assert kth[j] == pytest.approx(s[9], rel=1e-12)


def test_effective_query_codecs():
    q = torch.tensor([[0.5, -0.25, 0.125, 0.0]])
    np.testing.assert_array_equal(exact_topk.effective_query(q, "f32"),
                                  q.double())
    # i8s: scale 0.5 / 127; -0.25 / scale = -63.5 rounds to even -64
    e = exact_topk.effective_query(q, "i8s")
    s = np.float64(np.float32(0.5) / np.float32(127.0))
    np.testing.assert_allclose(e.numpy(), [[127 * s, -64 * s, 32 * s, 0.0]])
    # i4s: scale 0.5 / 7 rounds up in float32, so -0.25 / scale is
    # -3.4999998 -> -3; 0.125 / scale = 1.75 -> 2
    e = exact_topk.effective_query(q, "i4s")
    s = np.float64(np.float32(0.5) / np.float32(7.0))
    np.testing.assert_allclose(e.numpy(), [[7 * s, -3 * s, 2 * s, 0.0]])
    b = exact_topk.effective_query(torch.tensor([[1.0 + 2 ** -9]]), "bf16")
    assert float(b) == 1.0                           # ties to even
    with pytest.raises(ValueError):
        exact_topk.effective_query(q, "h16")


@pytest.mark.parametrize("query,levels", [("i8s", 127.0), ("i4s", 7.0)])
def test_quantization_is_float32_arithmetic(query, levels):
    """The reference's quantized query equals IEEE float32 arithmetic in
    NumPy (the scale max|q| / levels, the quotient q / scale, round half to
    even), element for element, on many queries."""
    q = corpus.make_queries(512, 1024, 3, "cpu").numpy()
    scale = (np.abs(q).max(axis=1) / np.float32(levels)).astype(np.float32)
    want = np.clip(np.round(q / scale[:, None]), -levels, levels)
    got = exact_topk.effective_query(torch.from_numpy(q), query).numpy()
    np.testing.assert_array_equal(got, want * scale[:, None].astype(np.float64))
