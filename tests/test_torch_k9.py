"""The row-order store of K9 and K4 as their plain versions compute it, on
the CPU.

``scores()`` is a zero fill and one launch of K9 (slice layout) or K4
(octet layout) that stores each slice lane's score, times the query's
scale in float32, at the lane's row. The plain versions' row-order form
(``row_ids``, ``scale``, ``out``) must give bit for bit what the port
computed before: the slice-order scores, then an int64 copy of
``row_ids``, ``torch.where`` sending padding lanes to one extra slot, the
multiply by ``scale * value_scale`` and ``scatter_`` into a zero fill
(``_scatter_before``). Held for every codec on both layouts, on one and
two partitions, with wide slices and wide octets, on a corpus with a row
that has no nnz (its score stays 0), through the wrappers, the plain
functions and ``scores()``. Tolerances: none (bits compared as int32).
``scores()`` against the JAX package's is held by tests/
test_torch_scores.py, test_torch_slice.py, test_torch_codecs_slice.py,
test_torch_codecs_octet.py and test_torch_partitions.py; this file runs
no interpret-mode program.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_topk_tpu_torch as pt
from spmv_topk_tpu_torch.formats import (CooMatrix, create_query_batch,
                                         create_sparse_matrix)
from spmv_topk_tpu_torch.ops import kernel as pkernel

ROWS, COLS = 2000, 1024
EMPTY_ROW = 7
CODECS = ("h16", "f32", "int8x4", "i8s", "i4s")
# (layout, geometry) -> config keywords; wide: slices (octets) past a block
GEOMETRIES = {
    ("slice", "narrow"): dict(fused_layout="slice", width_quantum=2,
                              fused_block_sublanes=128),
    ("slice", "wide"): dict(fused_layout="slice", width_quantum=2,
                            fused_block_sublanes=32),
    ("octet", "narrow"): dict(fused_layout="octet", width_quantum=2,
                              fused_block_sublanes=128),
    ("octet", "wide"): dict(fused_layout="octet", width_quantum=1,
                            fused_block_sublanes=64),
}
WRAPPERS = {"slice": pkernel.spmv_fused_scores_device,
            "octet": pkernel.spmv_fused_scores_octet_device}


@pytest.fixture(scope="module")
def corpus():
    coo = create_sparse_matrix(ROWS, COLS, 20, "gamma", seed=61)
    keep = coo.rows != EMPTY_ROW
    coo = CooMatrix(coo.rows[keep], coo.cols[keep], coo.vals[keep], ROWS,
                    COLS)
    return coo, create_query_batch(2, COLS, seed=62)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _scatter_before(eng, sc, scale):
    """The row order the port gave before the row-order store: slice
    order, then the epilogue over every slice row."""
    rows = eng.row_ids.reshape(-1).long()
    res = torch.zeros(eng.num_rows + 1, dtype=torch.float32)
    res.scatter_(0, torch.where(rows >= 0, rows, eng.num_rows),
                 sc.reshape(-1) * (scale * eng._value_scale))
    return res[:eng.num_rows]


def _engine(corpus, layout, geometry, codec, partitions):
    cfg = pt.TopKSpMVConfig(k=100, lane_k=8, max_cols=COLS,
                            query_codec=codec, rescore_pool=None,
                            num_partitions=partitions,
                            **GEOMETRIES[(layout, geometry)])
    return pt.TopKSpMV(corpus[0], cfg, device="cpu")


@pytest.mark.parametrize("partitions", [1, 2])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("layout,geometry", list(GEOMETRIES))
def test_row_store_is_slice_order_then_scatter(corpus, layout, geometry,
                                               codec, partitions):
    eng = _engine(corpus, layout, geometry, codec, partitions)
    plan = eng.fused.plan
    if geometry == "wide":
        assert any((p.blocks_per_slice if layout == "slice"
                    else p.blocks_per_octet) > 1 for p in plan)
    wrapper = WRAPPERS[layout]
    kw = dict(cfg=eng.config, block_sublanes=eng.fused.block_sublanes,
              num_slices=eng.row_ids.shape[0], num_partitions=partitions)
    for q in corpus[1]:
        table, scale = eng._table(q)
        args = (eng.words, table, eng.nreal, eng.plan_rows)
        before = wrapper.launches
        sc = wrapper(*args, **kw)
        want = _scatter_before(eng, sc, scale)
        out = torch.full((eng.num_rows,), 0.0)
        got = wrapper(*args, **kw, row_ids=eng.row_ids,
                      scale=scale * eng._value_scale, out=out)
        assert got is out and wrapper.launches == before
        assert torch.equal(_bits(got), _bits(want))
        assert got[EMPTY_ROW] == 0 and bool((got != 0).any())
        assert torch.equal(_bits(eng.scores(q)), _bits(want))


@pytest.mark.parametrize("layout", ["slice", "octet"])
def test_row_store_plain_forms(corpus, layout):
    """The plain functions themselves: the row-order form writes the rows
    that slice lanes hold and leaves the rest of ``out`` as it was (here
    three entries past the matrix's rows)."""
    eng = _engine(corpus, layout, "narrow", "h16", 1)
    table, scale = eng._table(corpus[1][0])
    plain = (pkernel.slice_scores_plain if layout == "slice"
             else pkernel.octet_scores_plain)
    kw = dict(num_slices=eng.row_ids.shape[0],
              block_sublanes=eng.fused.block_sublanes, codec="h16")
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    sc = plain(*args, **kw)
    out = torch.full((eng.num_rows + 3,), 5.0)
    got = plain(*args, **kw, row_ids=eng.row_ids,
                scale=scale * eng._value_scale, out=out)
    assert got is out
    want = _scatter_before(eng, sc, scale)
    held = torch.zeros(eng.num_rows + 3, dtype=torch.bool)
    held[eng.row_ids[eng.row_ids >= 0].long()] = True
    assert int(held.sum()) == eng.num_rows    # every row once, on one lane
    assert torch.equal(_bits(got[:eng.num_rows]), _bits(want))
    assert torch.equal(got[eng.num_rows:], torch.full((3,), 5.0))


def test_score_factor_is_torchs_rounding():
    """A float32 tensor times a Python scalar rounds the scalar to float32
    first: the row-order stores multiply by that float32 factor."""
    rng = np.random.default_rng(63)
    t = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    for scale in (0.1, 1 / 3, np.float64(0.0123456789012345),
                  np.float32(0.7) * 0.3, 3.3333333333333335e-05):
        f = pkernel.score_factor(scale)
        assert f == float(np.float32(f))
        assert torch.equal(_bits(t * scale), _bits(t * f))


@pytest.mark.parametrize("layout", ["slice", "octet"])
def test_row_store_needs_row_ids_and_out(corpus, layout):
    eng = _engine(corpus, layout, "narrow", "h16", 1)
    table, _ = eng._table(corpus[1][0])
    kw = dict(cfg=eng.config, block_sublanes=eng.fused.block_sublanes,
              num_slices=eng.row_ids.shape[0])
    args = (eng.words, table, eng.nreal, eng.plan_rows)
    with pytest.raises(ValueError, match="row_ids and out"):
        WRAPPERS[layout](*args, **kw, row_ids=eng.row_ids)
    with pytest.raises(ValueError, match="row_ids and out"):
        WRAPPERS[layout](*args, **kw, out=torch.zeros(eng.num_rows))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[layout](
            torch.empty((128, 128), dtype=torch.int32, **meta),
            torch.empty((1, 128), dtype=torch.int32, **meta),
            torch.empty((1, 1), dtype=torch.int32, **meta),
            torch.empty((1, 6 if layout == "slice" else 8),
                        dtype=torch.int32, **meta),
            cfg=eng.config, block_sublanes=128, num_slices=2,
            row_ids=torch.empty((2, 128), dtype=torch.int32, **meta),
            out=torch.empty(10, **meta))


def test_engine_refuses_row_ids_past_num_rows(corpus):
    """scores() stores at every row id on the card, so an engine whose
    row_ids reach past its rows is refused when it is built."""
    eng = _engine(corpus, "slice", "narrow", "h16", 1)
    f = eng.fused
    bad = np.array(f.row_ids)
    bad[0, 0] = f.num_rows
    with pytest.raises(ValueError, match="past num_rows"):
        pt.TopKSpMV.from_reference_arrays(
            f.words, f.nreal, bad, eng.plan_rows.numpy(),
            dict(config=dataclasses.asdict(eng.config), block_sublanes=f.block_sublanes,
                 num_blocks=f.num_blocks, num_rows=f.num_rows,
                 num_cols=f.num_cols, num_nnz=f.num_nnz,
                 value_scale=f.value_scale), device="cpu")


def _k9_variants():
    from spmv_topk_tpu_torch.experiments import k9_ablation
    return ([("new", n) for n in k9_ablation.PARTS]
            + [("old", n) for n in k9_ablation.OLD_PARTS])


@pytest.mark.parametrize("source,name", _k9_variants())
def test_k9_ablation_variants_patch_their_sources(tmp_path, source, name):
    """Every variant of experiments/k9_ablation.py finds each line it
    replaces exactly once, in the kernel's source (``PARTS``) or in the
    kernels before (``OLD_PARTS``), so that a kernel edit cannot leave a
    variant timing the unchanged kernel; the ablation's engines are valid
    configs."""
    from spmv_topk_tpu_torch.experiments import k9_ablation as abl
    from spmv_topk_tpu_torch.ops import _build

    if source == "old":
        text = abl.OLD_SOURCE
        for old, new in abl.OLD_PARTS[name]:
            assert text.count(old) == 1
            text = text.replace(old, new)
        assert (text != abl.OLD_SOURCE) == bool(abl.OLD_PARTS[name])
    else:
        abl.variant_dir(str(tmp_path), ("slice_scores.cu",), abl.PARTS[name])
        got = (tmp_path / "slice_scores.cu").read_text()
        with open(f"{_build.CSRC_DIR}/slice_scores.cu") as fh:
            assert (got != fh.read()) == bool(abl.PARTS[name])
    assert set(abl.ROW_ORDER) <= set(abl.EXACT) <= set(abl.PARTS)
    for config in abl.ROUTES.values():
        pt.TopKSpMVConfig(**config)
