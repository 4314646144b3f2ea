"""Query-vector quantization codecs (host side, NumPy).

The same codecs as ``spmv_topk_tpu.ops.quantized_query``, taken whole: a
query (``pack_query_table``) or a query group (``pack_query_tables``)
packs into the same int32 tables and scales in both packages. The h16 codec
uses the int4x8 table (``pack_query_i4s``): one 128-lane row covers 1024
columns, eight signed 4-bit entries per word.
"""

from __future__ import annotations

import numpy as np

from ..config import LANES


def pack_query_int8(vec_padded: np.ndarray):
    """(C,)-padded f32 query -> ((ceil(C/512), 128) int32 table, scale).

    Symmetric quantization q = round(x / scale) in [-127, 127], stored
    biased (q + 128) so the kernel extracts unsigned bytes. Scores computed
    with the quantized table are exactly `true_score_q / scale`.
    """
    C = len(vec_padded)
    scale = float(np.max(np.abs(vec_padded))) / 127.0
    if scale == 0.0:
        scale = 1.0
    q = np.clip(np.round(vec_padded / scale), -127, 127).astype(np.int64) + 128
    n_rows = -(-C // (4 * LANES))
    q = np.pad(q, (0, n_rows * 4 * LANES - C)).reshape(n_rows, 4, LANES)
    table = (
        q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
    ).astype(np.uint32).view(np.int32)
    return table, scale


def dequantize_query_int8(table: np.ndarray, scale: float, num_cols: int):
    """Inverse of pack_query_int8 (tests)."""
    t = table.view(np.uint32)
    parts = [(t >> (8 * b)) & 0xFF for b in range(4)]
    q = np.stack(parts, axis=1).reshape(-1)[:num_cols]
    return (q.astype(np.int64) - 128) * scale


def pack_query_i8s(vec_padded: np.ndarray):
    """Signed int8x4 table for the 'i8s' codec (sign-layout words).

    Same packing geometry as pack_query_int8 (4 bytes per int32 word, one
    128-lane row covers 512 columns) but bytes are two's-complement signed:
    the kernel extracts them with shift-left + arithmetic-shift-right only
    (no mask, no debias) because the matrix words carry a precomputed
    shift amount (see encode_words_i8s)."""
    C = len(vec_padded)
    scale = float(np.max(np.abs(vec_padded))) / 127.0
    if scale == 0.0:
        scale = 1.0
    q = np.clip(np.round(vec_padded / scale), -127, 127).astype(np.int8)
    n_rows = -(-C // (4 * LANES))
    q = np.pad(q, (0, n_rows * 4 * LANES - C)).view(np.uint8).astype(np.uint32)
    q = q.reshape(n_rows, 4, LANES)
    table = (
        q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
    ).view(np.int32)
    return table, scale


def dequantize_query_i8s(table: np.ndarray, scale: float, num_cols: int):
    t = table.view(np.uint32)
    parts = [((t >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
             for b in range(4)]
    q = np.stack(parts, axis=1).reshape(-1)[:num_cols]
    return q.astype(np.int64) * scale


def pack_query_i4s(vec_padded: np.ndarray):
    """Signed int4x8 table for the 'i4s' codec: one 128-lane row covers
    1024 columns, so any matrix up to max_cols=1024 gathers in a SINGLE
    take (the cheapest codec; ~4-bit query precision)."""
    C = len(vec_padded)
    scale = float(np.max(np.abs(vec_padded))) / 7.0
    if scale == 0.0:
        scale = 1.0
    q = np.clip(np.round(vec_padded / scale), -7, 7).astype(np.int64) & 0xF
    n_rows = -(-C // (8 * LANES))
    q = np.pad(q, (0, n_rows * 8 * LANES - C)).reshape(n_rows, 8, LANES)
    table = sum(
        (q[:, n].astype(np.uint32) << (4 * n)) for n in range(8)
    ).view(np.int32)
    return table, scale


def dequantize_query_i4s(table: np.ndarray, scale: float, num_cols: int):
    t = table.view(np.uint32)
    parts = []
    for n in range(8):
        nib = ((t >> (4 * n)) & 0xF).astype(np.int64)
        parts.append(np.where(nib >= 8, nib - 16, nib))
    q = np.stack(parts, axis=1).reshape(-1)[:num_cols]
    return q * scale


def pack_query_table(vec_padded: np.ndarray, codec: str):
    """(C,)-padded f32 query -> (table rows, score scale) for any codec."""
    if codec == "f32":
        return vec_padded.reshape(-1, LANES), 1.0
    if codec == "int8x4":
        return pack_query_int8(vec_padded)
    if codec == "i8s":
        return pack_query_i8s(vec_padded)
    if codec == "i4s":
        return pack_query_i4s(vec_padded)
    if codec == "h16":
        # matrix words carry 2 nnz each (col + 6-bit value halves); the
        # query side is the int4x8 single-row table
        return pack_query_i4s(vec_padded)
    raise ValueError(f"unknown query codec {codec!r}")


def pack_query_tables(qs_padded: np.ndarray, codec: str):
    """(Q, C)-padded f32 queries -> ((Q, rows, 128) tables, (Q,) scales).

    Vectorized batch form of pack_query_table: the serving path packs a
    whole query group in one NumPy pass and one device transfer. Unlike
    pack_query_table, the scales are float32 and the quantization divides
    by them in float32 (the JAX package's batch path; at a rounding
    boundary a query's table and scale can differ between the two)."""
    qs = np.asarray(qs_padded, np.float32)
    Qn, C = qs.shape
    if codec == "f32":
        return qs.reshape(Qn, -1, LANES), np.ones(Qn, np.float32)
    if codec in ("i4s", "h16"):
        scale = np.abs(qs).max(axis=1) / 7.0
        scale[scale == 0.0] = 1.0
        q = (np.clip(np.round(qs / scale[:, None]), -7, 7)
             .astype(np.int64) & 0xF)
        n_rows = -(-C // (8 * LANES))
        q = np.pad(q, ((0, 0), (0, n_rows * 8 * LANES - C))).reshape(
            Qn, n_rows, 8, LANES)
        table = sum((q[:, :, n].astype(np.uint32) << np.uint32(4 * n))
                    for n in range(8)).view(np.int32)
        return table, scale
    if codec == "int8x4":
        scale = np.abs(qs).max(axis=1) / 127.0
        scale[scale == 0.0] = 1.0
        q = np.clip(np.round(qs / scale[:, None]), -127, 127).astype(
            np.int64) + 128
        n_rows = -(-C // (4 * LANES))
        q = np.pad(q, ((0, 0), (0, n_rows * 4 * LANES - C))).reshape(
            Qn, n_rows, 4, LANES)
        table = (q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16)
                 | (q[:, :, 3] << 24)).astype(np.uint32).view(np.int32)
        return table, scale
    if codec == "i8s":
        scale = np.abs(qs).max(axis=1) / 127.0
        scale[scale == 0.0] = 1.0
        q = np.clip(np.round(qs / scale[:, None]), -127, 127).astype(np.int8)
        n_rows = -(-C // (4 * LANES))
        q = np.pad(q, ((0, 0), (0, n_rows * 4 * LANES - C))).view(
            np.uint8).astype(np.uint32).reshape(Qn, n_rows, 4, LANES)
        table = (q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16)
                 | (q[:, :, 3] << 24)).view(np.int32)
        return table, scale
    raise ValueError(f"unknown query codec {codec!r}")


def validate_codec(codec: str, max_cols: int) -> None:
    if codec == "i8s" and max_cols > 1024:
        raise ValueError("i8s codec supports max_cols <= 1024 "
                         "(table-row select is a single sign bit)")
    if codec == "i4s" and max_cols > 2048:
        raise ValueError("i4s codec supports max_cols <= 2048")
    if codec == "h16" and max_cols > 1024:
        raise ValueError("h16 codec supports max_cols <= 1024")
    if codec not in ("f32", "int8x4", "i8s", "i4s", "h16"):
        raise ValueError(f"unknown query codec {codec!r}")


def encode_words_sign_layout(words: np.ndarray, codec: str) -> np.ndarray:
    """Rewrite packed matrix words' high halves for the i8s/i4s codecs.

    Input words are `(col << 16) | bf16_bits`. The sign-layout word moves
    all per-word gather arithmetic to pack time:

      bits [ 0:16)  bf16 value bits           (unchanged)
      bits [16:23)  lane = col & 127          (hardware take wraps mod 128,
                                               so the bits above are free)
      bits [24:29)  arithmetic-shift amount   (i8s: 24-8*byte_index;
                                               i4s: 28-4*nibble_index)
      bit  31       table-row select          (col >= 512 for i8s @1024;
                                               col >= 1024 for i4s @2048)

    The kernel then needs only: take(s), optional sign-select, one
    shift-left, one arithmetic-shift-right, one int->float convert.
    """
    w = words.view(np.uint32)
    # All-uint32 fused forms (the straightforward version upcasts to int64
    # temporaries and costs ~14 s on a 1M x 1024 corpus slab):
    #   val|lane  = w & 0x007FFFFF   (val at [0:16), lane = col&127 already
    #                                 sits at [16:23) because col<<16)
    #   shift a<<24: i8s byte index at w[23:25) -> a = 24-8*idx
    #                => 0x18000000 - ((w << 4) & 0x18000000)
    #                i4s nibble index at w[23:26) -> a = 28-4*idx
    #                => 0x1C000000 - ((w << 3) & 0x1C000000)
    #   pass<<31:    i8s col bit 9 = w bit 25 -> (w << 6) & 0x80000000
    #                i4s col bit 10 = w bit 26 -> (w << 5) & 0x80000000
    base = w & np.uint32(0x007FFFFF)
    if codec == "i8s":
        a = np.uint32(0x18000000) - ((w << np.uint32(4))
                                     & np.uint32(0x18000000))
        p = (w << np.uint32(6)) & np.uint32(0x80000000)
    elif codec == "i4s":
        a = np.uint32(0x1C000000) - ((w << np.uint32(3))
                                     & np.uint32(0x1C000000))
        p = (w << np.uint32(5)) & np.uint32(0x80000000)
    else:
        raise ValueError(f"not a sign-layout codec: {codec!r}")
    return (base | a | p).view(np.int32)
