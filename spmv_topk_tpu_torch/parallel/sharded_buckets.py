"""Row-sharded Top-K SpMV on the bucketed (fused) layout.

The counterpart of ``spmv_topk_tpu.parallel.sharded_buckets``. Every
shard shares one *bucket skeleton*, as there (one ``shard_map`` program
runs on every device there; here one plan keeps the shards' streams and
candidates alike):

  1. rows are split into contiguous equal blocks, one per mesh position
     (the reference's partition rule, host_spmv_bscsr.cpp:136-141), and
     with ``config.num_partitions`` P > 1 each shard into P partitions;
  2. each partition is SELL-bucket-packed on its own
     (``pack_sell_buckets``, h16 values on one global scale);
  3. the skeleton is the union of bucket widths with per-width block
     counts (octet stream: member strides) maxed over every partition of
     every shard of every process; a partition lacking a width gets zero
     real slices there;
  4. per-shard ``row_ids`` map skeleton slice positions to global rows.

A query sweeps each shard on its device with the port's fused sweep
(``ops.kernel.topk_spmv_fused_device`` / ``_octet_device``, the batch
sweeps for ``query_batch``; on P > 1 partitions the same functions with a
partition axis, K10a-d on the card), resolves the shard's candidates to
global rows there (``finalize_topk_batch``: ``TOPK_FLOOR``, ``row_ids``,
a local top-k), gathers the shards' (k) pairs onto the first device of
the mesh, and takes their top-k: the JAX engine's ``all_gather`` and
``lax.top_k``.

Several processes (``torch.distributed``): each process packs only the
rows of its own mesh positions (``local_rows=(row_lo, global_rows)``
with a matrix of just that row slice). The skeleton (a fixed 256-slot
payload of (width, blocks) pairs), the h16 value scale and the word
buffer's length are agreed with one ``all_gather`` each, and the merge
gathers every process's candidates (``distributed.all_gather``), so every
process returns the same answer. The exact rescore keeps each process's
CSR slice and merges the rescored candidates across processes; it runs
serially there, since every process must issue the collectives in the
same order.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, LANES, TopKSpMVConfig, ValueFormat
from ..formats.coo import CooMatrix
from ..formats.sell_buckets import (fuse_buckets, fuse_buckets_octet,
                                    octet_plan_array, octet_plan_from_array,
                                    pack_sell_buckets, slice_plan_array,
                                    slice_plan_from_array)
from ..ops import kernel as K
from . import distributed
from .mesh import make_mesh

_SKELETON_SLOTS = 256  # fixed-size allgather payload: (width, blocks) pairs


class ShardedBucketedTopKSpMV:
    """Multi-device engine on the bucketed layout (one process or
    several)."""

    def __init__(self, matrix: CooMatrix,
                 config: TopKSpMVConfig = DEFAULT_CONFIG, mesh=None,
                 local_rows: Optional[tuple] = None,
                 exchange_skeleton: Optional[bool] = None):
        """mesh: a list of devices (``mesh.make_mesh``; default every
        visible CUDA device, or ``distributed.global_mesh()`` with
        several processes). local_rows: ``(row_lo, global_num_rows)`` —
        ``matrix`` holds only this process's contiguous row slice, from
        global row ``row_lo`` of a ``global_num_rows``-row corpus; None
        means ``matrix`` is the whole corpus.

        config.num_partitions > 1 packs each shard as P partitions swept
        by the partitioned kernels, a pool of candidates per partition.

        exchange_skeleton: run the processes' skeleton / scale exchange
        even in one process (None: with several processes), which runs
        the multi-process code on one process.
        """
        if config.fused_layout == "octet" and not config.sigma_sort:
            raise ValueError(
                "fused_layout='octet' on a sharded engine requires "
                "sigma_sort=True: the cross-shard bucket skeleton cannot "
                "hold duplicate widths in the transposed stream")
        self._setup_mesh(mesh, config)
        D = len(self.mesh)
        exchange = (distributed.world_size() > 1 if exchange_skeleton is None
                    else bool(exchange_skeleton))
        self.num_cols = matrix.num_cols
        NP = config.num_partitions

        if not matrix.is_sorted_row_major():
            matrix = matrix.sort_row_major()

        if local_rows is None:
            row_lo, global_rows = 0, matrix.num_rows
        else:
            row_lo, global_rows = int(local_rows[0]), int(local_rows[1])
        self.num_rows = global_rows
        rows_per_shard = -(-global_rows // D)
        my_pos = self._my_pos

        # the rescore keeps only this process's rows of the CSR
        self._csr_lo = my_pos[0] * rows_per_shard
        self._csr_hi = min((my_pos[-1] + 1) * rows_per_shard, global_rows)
        if config.rescore_pool:
            if local_rows is None and distributed.world_size() == 1:
                self._scipy_csr = matrix.to_scipy_csr()
                self._csr_lo, self._csr_hi = 0, global_rows
            else:
                self._scipy_csr = matrix.row_slice(
                    self._csr_lo - row_lo,
                    self._csr_hi - row_lo).to_scipy_csr()
        else:
            self._scipy_csr = None

        # h16 quantizes values with ONE global scale so per-shard scores
        # stay comparable across devices at the merge
        self._value_scale = 1.0
        vscale = None
        if config.query_codec == "h16":
            vmax = float(np.max(np.abs(matrix.vals))) if matrix.nnz else 0.0
            if exchange:
                vmax = float(distributed.process_allgather(
                    np.float32(vmax)).max())
            vscale = ((vmax or 1.0) / 31.0) or 1.0
            self._value_scale = vscale

        # pack only this process's shards: NP partition units per position
        packs = []
        for pos in my_pos:
            lo = pos * rows_per_shard
            hi = min(lo + rows_per_shard, global_rows)
            if not (row_lo <= lo and hi <= row_lo + matrix.num_rows):
                raise ValueError(
                    f"device shard rows [{lo},{hi}) outside this process's "
                    f"matrix rows [{row_lo},{row_lo + matrix.num_rows}) — "
                    "pass the slice from distributed.local_shard_rows")
            local = matrix.row_slice(lo - row_lo, hi - row_lo)
            if local.num_rows <= 0 or local.nnz == 0:
                raise ValueError(f"shard {pos} is empty ({D} devices)")
            rows_per_part = -(-local.num_rows // NP)
            units = []
            for p in range(NP):
                plo = p * rows_per_part
                phi = min(plo + rows_per_part, local.num_rows)
                part = local.row_slice(plo, phi)
                if part.num_rows <= 0 or part.nnz == 0:
                    raise ValueError(
                        f"partition {p} of shard {pos} is empty — lower "
                        "config.num_partitions")
                units.append((lo + plo, pack_sell_buckets(
                    part, config, value_scale=vscale)))
            packs.append(units)

        # the common skeleton: widths descending, per width the most
        # blocks (slice) or octets (octet) of any partition of any shard
        tgt = config.fused_block_sublanes
        octet = config.fused_layout == "octet"
        S = config.chunk_sublanes
        by_width: dict = {}
        for units in packs:
            for _, m in units:
                if octet:
                    for b in m.buckets:
                        g = -(-b.num_slices // S)
                        by_width[b.width] = max(by_width.get(b.width, 0), g)
                    continue
                for p in fuse_buckets(m, block_sublanes=tgt).plan:
                    by_width[p.width] = max(by_width.get(p.width, 0),
                                            p.num_blocks)
        if exchange:
            pairs = np.zeros((_SKELETON_SLOTS, 2), np.int32)
            items = sorted(by_width.items(), reverse=True)
            if len(items) > _SKELETON_SLOTS:
                raise ValueError(f"{len(items)} bucket widths exceed the "
                                 f"{_SKELETON_SLOTS}-slot skeleton exchange")
            for i, (w, nb) in enumerate(items):
                pairs[i] = (w, nb)
            allp = distributed.process_allgather(pairs).reshape(-1, 2)
            by_width = {}
            for w, nb in allp[allp[:, 0] > 0]:
                by_width[int(w)] = max(by_width.get(int(w), 0), int(nb))
        skeleton = []
        base = 0
        for w in sorted(by_width, reverse=True):
            nb = by_width[w]
            skeleton.append((w, nb, base))
            if octet:
                base += S * nb   # nb = G here; S*G slice ids per width
            else:
                spb = tgt // w if w <= tgt else 1
                bps = 1 if w <= tgt else -(-w // tgt)
                base += (nb * spb) if bps == 1 else (nb // bps)
        total_slices = base

        fuse = fuse_buckets_octet if octet else fuse_buckets
        fused = [[fuse(m, block_sublanes=tgt, skeleton=skeleton)
                  for _, m in units] for units in packs]
        plan0 = fused[0][0].plan
        nb_words = max(f.words.shape[0] for fs in fused for f in fs)
        if exchange:
            nb_words = int(distributed.process_allgather(
                np.int32(nb_words)).max())

        shard_words, shard_nreal, shard_rows = [], [], []
        for units, fs in zip(packs, fused):
            w = np.zeros((1, NP * nb_words, LANES), np.int32)
            nr = np.zeros((1, NP, len(plan0), 1), np.int32)
            rid = np.full((1, NP * (total_slices + 1), LANES), -1, np.int32)
            for p, ((row0, m), f) in enumerate(zip(units, fs)):
                assert f.plan == plan0, "skeleton plans must agree"
                w[0, p * nb_words: p * nb_words + f.words.shape[0]] = f.words
                nr[0, p, :, 0] = f.nreal[:, 0]
                r0 = p * (total_slices + 1)
                for q, n_sl in zip(f.plan, f.nreal[:, 0]):
                    if n_sl == 0:
                        continue  # this unit has no slices of this width
                    src = next(b for b in m.buckets if b.width == q.width)
                    ids = m.row_ids[src.slice_base:
                                    src.slice_base + int(n_sl)].copy()
                    ids[ids >= 0] += row0
                    rid[0, r0 + q.slice_base:
                        r0 + q.slice_base + int(n_sl)] = ids
            shard_words.append(w)
            shard_nreal.append(nr)
            shard_rows.append(rid)

        self._finalize(config, plan0, fused[0][0].num_blocks, tgt, nb_words,
                       total_slices, shard_words, shard_nreal, shard_rows)

    # ------------------------------------------------------------------

    def _setup_mesh(self, mesh, config):
        if mesh is None:
            mesh = (distributed.global_mesh()
                    if distributed.world_size() > 1 else make_mesh())
        self.mesh = mesh
        self.config = config
        # merge width: widened to the rescore pool so the host re-ranking
        # has enough exact candidates (see api.TopKSpMV._rescore)
        self._merge_k = max(config.k, config.rescore_pool or 0)
        self._my_pos = distributed.positions(mesh)
        if not self._my_pos:
            raise ValueError(f"process {distributed.rank()} owns no "
                             "devices of the mesh")
        # results live on this process's first device of the mesh
        self.device = torch.device(mesh[self._my_pos[0]])

    def _finalize(self, config, plan, num_blocks, tgt, nb_words,
                  total_slices, shard_words, shard_nreal, shard_rows):
        """Each of this process's shards on its device: words, nreal,
        row_ids (as the snapshot holds them, without the leading axis) and
        the kernels' plan table."""
        NP = config.num_partitions
        self.fused_plan = plan
        self.fused_num_blocks = num_blocks
        self.fused_block_sublanes = tgt
        self._nb_words = nb_words
        self._total_slices = total_slices
        octet = config.fused_layout == "octet"
        self._shards = []
        for pos, w, nr, rid in zip(self._my_pos, shard_words, shard_nreal,
                                   shard_rows):
            dev = torch.device(self.mesh[pos])
            if w.shape != (1, NP * nb_words, LANES) or \
                    nr.shape != (1, NP, len(plan), 1) or \
                    rid.shape != (1, NP * (total_slices + 1), LANES):
                raise ValueError(f"shard {pos}'s arrays do not match the "
                                 "plan")
            nreal = nr[0] if NP > 1 else nr[0, 0]
            rows = (K.octet_plan_rows(plan, num_blocks) if octet else
                    K.slice_plan_rows(plan, num_blocks, nreal, tgt))
            self._shards.append({
                name: torch.from_numpy(np.ascontiguousarray(
                    arr, np.int32)).to(dev)
                for name, arr in (("words", w[0]), ("nreal", nreal),
                                  ("row_ids", rid[0]), ("plan_rows", rows))})

    # -- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        """Per-shard snapshot in the JAX engine's format:
        ``{path}.meta.npz`` (rank 0) plus one ``{path}.shard{pos:04d}.npz``
        per mesh position, each written by the process owning it. The
        rescore CSR is not kept (it is the raw matrix): pass the matrix
        slice to load() to restore exact rescoring."""
        if distributed.rank() == 0:
            octet = self.config.fused_layout == "octet"
            plan_arr = (octet_plan_array if octet
                        else slice_plan_array)(self.fused_plan)
            meta = dict(config=dataclasses.asdict(self.config),
                        block_sublanes=self.fused_block_sublanes,
                        num_blocks=self.fused_num_blocks,
                        nb_words=self._nb_words,
                        total_slices=self._total_slices,
                        num_devices=len(self.mesh),
                        num_rows=self.num_rows, num_cols=self.num_cols,
                        value_scale=self._value_scale, format_version=1)
            with open(f"{path}.meta.npz", "wb") as fh:
                np.savez(fh, plan=plan_arr, meta=np.frombuffer(
                    json.dumps(meta).encode(), np.uint8))
        NP = self.config.num_partitions
        for pos, sh in zip(self._my_pos, self._shards):
            nreal = sh["nreal"].cpu().numpy()
            nreal = nreal[None] if NP > 1 else nreal[None, None]
            with open(f"{path}.shard{pos:04d}.npz", "wb") as fh:
                np.savez(fh, words=sh["words"].cpu().numpy()[None],
                         nreal=nreal,
                         row_ids=sh["row_ids"].cpu().numpy()[None])

    @classmethod
    def load(cls, path: str, mesh=None, matrix: Optional[CooMatrix] = None,
             local_rows: Optional[tuple] = None):
        """Engine from save() of either package: each process reads only
        its own positions' shard files. The mesh must have the snapshot's
        device count. matrix (+ local_rows, as for __init__): the source
        rows to rebuild the rescore CSR from; without it a rescore_pool
        config serves un-rescored, with a warning."""
        with np.load(f"{path}.meta.npz") as z:
            meta = json.loads(bytes(z["meta"]).decode())
            plan_arr = z["plan"]
        cfg_d = dict(meta["config"])
        cfg_d["value_format"] = ValueFormat(**cfg_d["value_format"])
        config = TopKSpMVConfig(**cfg_d)
        plan = (octet_plan_from_array if config.fused_layout == "octet"
                else slice_plan_from_array)(plan_arr)

        self = cls.__new__(cls)
        self._setup_mesh(mesh, config)
        D = len(self.mesh)
        if D != int(meta["num_devices"]):
            raise ValueError(
                f"snapshot was saved for {meta['num_devices']} devices, "
                f"mesh has {D}")
        self.num_rows = int(meta["num_rows"])
        self.num_cols = int(meta["num_cols"])
        self._value_scale = float(meta["value_scale"])

        rows_per_shard = -(-self.num_rows // D)
        self._csr_lo = self._my_pos[0] * rows_per_shard
        self._csr_hi = min((self._my_pos[-1] + 1) * rows_per_shard,
                           self.num_rows)
        self._scipy_csr = None
        if config.rescore_pool:
            if matrix is None:
                warnings.warn(
                    "loaded sharded engine has no host CSR: rescore_pool "
                    "disabled (pass matrix= to load() to restore exact "
                    "rescoring)", stacklevel=2)
            else:
                row_lo = int(local_rows[0]) if local_rows else 0
                self._scipy_csr = matrix.row_slice(
                    self._csr_lo - row_lo,
                    self._csr_hi - row_lo).to_scipy_csr()

        shard_words, shard_nreal, shard_rows = [], [], []
        for pos in self._my_pos:
            with np.load(f"{path}.shard{pos:04d}.npz") as s:
                shard_words.append(s["words"])
                shard_nreal.append(s["nreal"])
                shard_rows.append(s["row_ids"])
        self._finalize(config, plan, int(meta["num_blocks"]),
                       int(meta["block_sublanes"]), int(meta["nb_words"]),
                       int(meta["total_slices"]),
                       shard_words, shard_nreal, shard_rows)
        return self

    # -- query path -----------------------------------------------------

    def _sweep_kw(self) -> dict:
        NP = self.config.num_partitions
        kw = dict(cfg=self.config, block_sublanes=self.fused_block_sublanes)
        if NP > 1:
            kw.update(num_partitions=NP, part_slices=self._total_slices + 1)
        return kw

    def _sweeps(self, batch: bool):
        octet = self.config.fused_layout == "octet"
        if batch:
            return (K.topk_spmv_fused_batch_octet_device if octet
                    else K.topk_spmv_fused_batch_device)
        return (K.topk_spmv_fused_octet_device if octet
                else K.topk_spmv_fused_device)

    def _local_topk(self, tables, batch: bool):
        """Each of this process's shards swept on its device and resolved
        to its local top-k: [(rows (Q, kk) int32, values (Q, kk) f32)], Q
        = 1 for one query. tables: the query table(s), (rows, 128) or
        (Q, rows, 128) on the CPU."""
        sweep = self._sweeps(batch)
        kw = self._sweep_kw()
        out = []
        for sh in self._shards:
            dev = sh["words"].device
            tv, tt = sweep(sh["words"], tables.to(dev), sh["nreal"],
                           sh["plan_rows"], **kw)
            if not batch:
                tv, tt = tv[None], tt[None]
            out.append(K.finalize_topk_batch(tv, tt, sh["row_ids"],
                                             k=self._merge_k))
        return out

    def _merge(self, local):
        """The global top-k of every shard's (Q, kk) candidates, in mesh
        position order, on this process's first device: (rows (Q, k'),
        values (Q, k')), k' = min(merge width, D * kk)."""
        dev = self.device
        rows = torch.stack([r.to(dev) for r, _ in local])   # (n, Q, kk)
        vals = torch.stack([v.to(dev) for _, v in local])
        if distributed.world_size() > 1:
            owners = self.mesh.owners
            most = max(owners.count(r) for r in set(owners))
            pad = most - rows.shape[0]
            if pad:
                rows = torch.cat([rows, rows.new_full(
                    (pad, *rows.shape[1:]), -1)])
                vals = torch.cat([vals, vals.new_full(
                    (pad, *vals.shape[1:]), float("-inf"))])
            grows = distributed.all_gather(rows)            # (world, most, ..)
            gvals = distributed.all_gather(vals)
            seen = {}
            order = []
            for r in owners:                  # position order
                order.append(r * most + seen.get(r, 0))
                seen[r] = seen.get(r, 0) + 1
            idx = torch.tensor(order, device=dev)
            rows = grows.reshape(-1, *rows.shape[1:])[idx]
            vals = gvals.reshape(-1, *vals.shape[1:])[idx]
        Q = rows.shape[1]
        flat_r = rows.permute(1, 0, 2).reshape(Q, -1)
        flat_v = vals.permute(1, 0, 2).reshape(Q, -1)
        fv, fpos = torch.topk(flat_v, min(self._merge_k, flat_v.shape[1]),
                              dim=1)
        return torch.gather(flat_r, 1, fpos), fv

    def _table(self, vec):
        """(query table on the CPU, its score scale)."""
        from ..ops.quantized_query import pack_query_table

        vec = np.asarray(vec, dtype=np.float32)
        padded = np.zeros(self.config.max_cols, np.float32)
        padded[: self.num_cols] = vec
        tab, scale = pack_query_table(padded, self.config.query_codec)
        return torch.from_numpy(np.ascontiguousarray(tab)), scale

    def _rescore_global(self, idx, vec, k: int):
        """Exact re-rank of merged candidates against this process's CSR
        slice, combined across processes (distributed read_result,
        host_spmv_bscsr.cpp:399-448). Returns NumPy (rows int32, values)."""
        from ..api import exact_rescore

        idx = np.asarray(idx).reshape(-1)
        local = idx[(idx >= self._csr_lo) & (idx < self._csr_hi)]
        li, lv = exact_rescore(self._scipy_csr, local - self._csr_lo,
                               vec, k)
        li = np.where(li >= 0, li + self._csr_lo, -1).astype(np.int32)
        if distributed.world_size() > 1:
            gi = distributed.process_allgather(li).reshape(-1)
            gv = distributed.process_allgather(lv).reshape(-1)
            order = np.argsort(-gv, kind="stable")[:k]
            li, lv = gi[order].astype(np.int32), gv[order]
        return li, lv

    def _check_k(self, k):
        if (k or self.config.k) > self._merge_k:
            raise ValueError(
                f"k={k} exceeds the build-time merge width "
                f"{self._merge_k} (config.k={self.config.k}; "
                f"config.rescore_pool widens it)")

    def query(self, vec, k: Optional[int] = None):
        """Top-k rows by A @ vec: (rows int32, values f32) tensors on this
        process's first device of the mesh, values descending."""
        self._check_k(k)
        k = k or self.config.k
        table, scale = self._table(vec)
        idx, vals = self._merge(self._local_topk(table, batch=False))
        idx, vals = idx[0], vals[0]
        if self._scipy_csr is not None:
            li, lv = self._rescore_global(idx.cpu().numpy(), vec, k)
            return (torch.from_numpy(li).to(self.device),
                    torch.from_numpy(lv).to(self.device))
        scale = scale * self._value_scale
        if scale != 1.0:
            vals = vals * scale
        return idx[:k], vals[:k]

    def query_batch(self, queries, k: Optional[int] = None,
                    group_size: int = 8):
        """Batched queries (Q, C) -> (Q, k) rows and values: the batch
        sweep per shard and group, the merge of (Q, k) candidates per
        shard. A tail group is padded with copies of its last query, as
        the JAX engine does, and the copies dropped."""
        from ..api import rescore_executor
        from ..ops.quantized_query import pack_query_tables

        self._check_k(k)
        queries = np.asarray(queries, dtype=np.float32)
        rescore = self._scipy_csr is not None
        # one process: the host rescore of a group overlaps the next
        # group's sweeps on a thread pool; several: serial (the rescore's
        # collectives run in the same order everywhere)
        threaded = rescore and distributed.world_size() == 1
        kk = k or self.config.k
        idx_all, val_all, futs = [], [], []
        for start in range(0, len(queries), group_size):
            chunk = queries[start:start + group_size]
            n_real = len(chunk)
            if n_real < group_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], group_size - n_real, 0)])
            padded = np.zeros((len(chunk), self.config.max_cols), np.float32)
            padded[:, : self.num_cols] = chunk
            tabs, scales = pack_query_tables(padded, self.config.query_codec)
            idx, vals = self._merge(self._local_topk(
                torch.from_numpy(tabs), batch=True))
            if rescore:
                host = idx.cpu().numpy()
                if threaded:
                    ex = rescore_executor(self)
                    futs += [ex.submit(self._rescore_global, host[q],
                                       chunk[q], kk) for q in range(n_real)]
                else:
                    futs += [self._rescore_global(host[q], chunk[q], kk)
                             for q in range(n_real)]
                continue
            vals = vals * (torch.from_numpy(scales).to(self.device)[:, None]
                           * self._value_scale)
            if k is not None and k < self._merge_k:
                idx, vals = idx[:, :k], vals[:, :k]
            idx_all.append(idx[:n_real])
            val_all.append(vals[:n_real])
        if rescore:
            outs = [f.result() if threaded else f for f in futs]
            return (torch.from_numpy(np.stack([o[0] for o in outs]))
                    .to(self.device),
                    torch.from_numpy(np.stack([o[1] for o in outs]))
                    .to(self.device))
        return torch.cat(idx_all), torch.cat(val_all)

    @property
    def hbm_bytes(self) -> int:
        """Bytes of packed words over every shard of the mesh."""
        return len(self.mesh) * self.config.num_partitions * \
            self._nb_words * LANES * 4
