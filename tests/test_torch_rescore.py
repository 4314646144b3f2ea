"""The exact rescore of both packages on one corpus, path by path.

``api.exact_rescore`` scores a candidate pool by its CSR rows either in
the native runtime (float32, each row in order) or, where that library is
missing, in NumPy (a float64 cumsum, rounded once). The two paths give the
same rows but not the same last bits, so the parity tests that hold
rescored values bit for bit pin both packages to one path
(``rescore_paths.py``). Here:
  - both native paths: indices and values bit for bit;
  - both NumPy paths: the same;
  - native against NumPy on this corpus: some value differs, which is why
    the paths must be pinned.
"""

import numpy as np
import pytest

from spmv_topk_tpu import api as japi
from spmv_topk_tpu.utils import native as jnative

from spmv_topk_tpu_torch import api as papi
from spmv_topk_tpu_torch.formats import (create_sample_vector,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.utils import native as pnative

from rescore_paths import load_both_natives

ROWS, COLS, POOL, K = 4000, 256, 400, 100


@pytest.fixture(scope="module")
def corpus():
    load_both_natives()
    coo = create_sparse_matrix(ROWS, COLS, 24, "gamma", seed=501)
    q = create_sample_vector(COLS, seed=502)
    pool = np.random.default_rng(503).choice(ROWS, POOL, replace=False)
    return coo, q, pool


def _rescore(module, corpus):
    """(indices, values) of one package's exact_rescore, on a CSR of its
    own (the normalized arrays are cached on the CSR object)."""
    coo, q, pool = corpus
    return module.exact_rescore(coo.to_scipy().tocsr(), pool, q, K)


def _numpy_paths(monkeypatch):
    for native in (jnative, pnative):
        monkeypatch.setattr(native, "csr_rescore", lambda *a: None)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_packages_rescore_alike_on_one_path(corpus, monkeypatch, path):
    if path == "numpy":
        _numpy_paths(monkeypatch)
    ji, jv = _rescore(japi, corpus)
    pi, pv = _rescore(papi, corpus)
    assert jv.dtype == pv.dtype == np.float32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)


def test_native_and_numpy_paths_differ(corpus, monkeypatch):
    native = [_rescore(m, corpus) for m in (japi, papi)]
    _numpy_paths(monkeypatch)
    numpy = [_rescore(m, corpus) for m in (japi, papi)]
    for (ni, nv), (mi, mv) in zip(native, numpy):
        # the same rows, scores within an ulp or two, not bit for bit
        np.testing.assert_allclose(np.sort(nv), np.sort(mv), rtol=1e-6)
        assert not np.array_equal(nv, mv)
