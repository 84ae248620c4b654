"""Halo-exchange SpGEMM: B stays sharded; needed tiles ride point-to-point
rounds between the ranks, on torch.distributed.

The port of :mod:`spada_tpu.parallel.halo`.  ``HaloProblem`` and
:func:`partition_halo` are copies of the reference's, held equal to it by
``tests/test_torch_host.py``: the mesh is 1-D (``dp``), A and C are row-panel
sharded and B is k-slab sharded, so no rank holds all of B.  Each rank's
worklist is segmented by the round that brings its B tiles: round r ships
``b_local[send_idx[r-1][src]]`` from every rank src to ``(src + r) % D``.

The device side (:func:`spgemm_halo`) issues every round at once, before
any compute, in one ``batch_isend_irecv`` (the transfers depend only on the
resident B tiles), runs the local segment while they are in flight, then
waits for each round in turn and adds its segment.  The engine is the
sharded path's (:func:`~spada_tpu_torch.parallel.spgemm.prepare_segment`):
``tile_spgemm`` once per round that has real items (an empty round
launches nothing), partial sums in f32, tiles shipped bf16 by default; or
the plain f32 engine.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.convert import c_tiles_to_numpy, check_device
from spada_tpu_torch.parallel.mesh import gather, global_rank, resolve_mesh
from spada_tpu_torch.parallel.partition import _balanced_row_splits
from spada_tpu_torch.parallel.spgemm import (ShardedResult, prepare_segment,
                                             resolve_engine, tile_dtype)
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class HaloProblem:
    """Static-shape inputs for the halo-exchange strategy.

    Layouts (D = n_dev; round r ∈ [1, D) ships src → (src+r) % D):
      b_tiles   f32 [D, Bmax, tk, tn]     local B tiles per owner (k-slabs);
                                          slot Bmax-1 is a zero pad tile
      send_idx  list of i32 [D, cap_r]    send_idx[r-1][src] = local tile
                                          slots src ships in round r
      a_tiles   f32 [D, Amax, tm, tk]     slot Amax-1 is a zero pad tile
      a_tid/b_tid/o_tid i32 [D, ΣWseg]    worklists segmented by round:
                                          items [seg_ptr[r], seg_ptr[r+1])
                                          use B from round r (0 = local).
                                          b_tid indexes the local buffer
                                          (round 0) or the round's receive
                                          buffer; padded items hit the zero
                                          tile / the o dump slot nCmax.
      c_tile_row/col i32 [D, nCmax]
    """

    n_dev: int
    tm: int
    tk: int
    tn: int
    caps: List[int]          # caps[r-1] = round-r per-pair tile capacity
    seg_ptr: List[int]       # length D+1: worklist segment boundaries
    shape: Tuple[int, int]
    a_tiles: np.ndarray
    b_tiles: np.ndarray
    send_idx: List[np.ndarray]
    a_tid: np.ndarray
    b_tid: np.ndarray
    o_tid: np.ndarray
    c_tile_row: np.ndarray
    c_tile_col: np.ndarray
    row_base: np.ndarray
    n_c_tiles: np.ndarray
    nCmax: int
    halo_tiles_sent: int     # true (unpadded) tiles exchanged
    halo_tiles_padded: int   # tile slots actually shipped (Σ_r D·cap_r)


def partition_halo(
    a: CsrMatrix,
    b: CsrMatrix,
    n_dev: int,
    config: Optional[SpadaConfig] = None,
    tm: Optional[int] = None,
) -> HaloProblem:
    config = config or SpadaConfig()
    tm = tm or config.default_tm
    tk, tn = config.tile_k, config.tile_n

    a_bsr = BsrMatrix.from_csr(a, tm, tk, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, tk, tn, dtype=np.float32)
    a_rows = a_bsr.tile_rows()
    b_rows = b_bsr.tile_rows()
    b_fan = np.diff(b_bsr.tile_rowptr)

    # dp split of A tile-rows by work; k-slab split of B by tile count
    per_tile_work = b_fan[a_bsr.tile_col.astype(np.int64)]
    wrow = np.zeros(a_bsr.n_tile_rows, np.int64)
    np.add.at(wrow, a_rows.astype(np.int64), per_tile_work)
    dp_bounds = _balanced_row_splits(wrow, n_dev)
    k_bounds = _balanced_row_splits(np.maximum(b_fan, 1), n_dev)
    owner_of_k = np.zeros(b_bsr.n_tile_rows, np.int64)
    for d in range(n_dev):
        owner_of_k[k_bounds[d] : k_bounds[d + 1]] = d

    # local B tiles per owner
    b_owner = owner_of_k[b_rows.astype(np.int64)]
    local_b = [np.nonzero(b_owner == d)[0] for d in range(n_dev)]
    b_local_slot = np.full(b_bsr.n_tiles, -1, np.int64)
    for d in range(n_dev):
        b_local_slot[local_b[d]] = np.arange(len(local_b[d]))

    # per-device worklists (global B ids) + per-item source round
    dev_data = []
    for d in range(n_dev):
        r0, r1 = dp_bounds[d], dp_bounds[d + 1]
        a_sel = np.nonzero((a_rows >= r0) & (a_rows < r1))[0]
        k_all = a_bsr.tile_col[a_sel].astype(np.int64)
        fan = b_fan[k_all]
        Wd = int(fan.sum())
        if Wd:
            rep = np.repeat(np.arange(len(a_sel)), fan)
            starts = b_bsr.tile_rowptr[k_all]
            offs = np.arange(Wd) - np.repeat(np.cumsum(fan) - fan, fan)
            b_ids = np.repeat(starts, fan) + offs
            ti = (a_rows[a_sel].astype(np.int64) - r0)[rep]
            tj = b_bsr.tile_col[b_ids].astype(np.int64)
            key = ti * b_bsr.n_tile_cols + tj
            uniq = np.unique(key)
            o_l = np.searchsorted(uniq, key)
            rounds = (d - b_owner[b_ids]) % n_dev  # 0 = local
        else:
            rep = b_ids = o_l = uniq = rounds = np.zeros(0, np.int64)
        dev_data.append((r0, a_sel, rep, b_ids, o_l, uniq, rounds))

    # per-round send lists + per-offset capacities.  Round r: src ships to
    # dst = (src + r) % D exactly the tiles dst needs from src.
    send_lists = [[None] * n_dev for _ in range(n_dev)]  # [src][dst]
    total_sent = 0
    for dst in range(n_dev):
        b_ids = dev_data[dst][3]
        need = np.unique(b_ids)
        owners = b_owner[need] if len(need) else np.zeros(0, np.int64)
        for src in range(n_dev):
            if src == dst:
                send_lists[src][dst] = np.zeros(0, np.int64)
                continue
            ids = need[owners == src]
            send_lists[src][dst] = ids
            total_sent += len(ids)
    caps = []
    for r in range(1, n_dev):
        caps.append(max(
            (len(send_lists[src][(src + r) % n_dev])
             for src in range(n_dev)), default=0) or 1)

    # per-device, per-round segment sizes -> shared static segment layout
    seg_need = np.zeros((n_dev, n_dev), np.int64)  # [device, round]
    for d in range(n_dev):
        rounds = dev_data[d][6]
        if len(rounds):
            np.add.at(seg_need[d], rounds.astype(np.int64), 1)
    seg_len = [max(int(seg_need[:, r].max()), 1) for r in range(n_dev)]
    seg_ptr = [0]
    for r in range(n_dev):
        seg_ptr.append(seg_ptr[-1] + seg_len[r])
    Wtot = seg_ptr[-1]

    Amax = max((len(d[1]) for d in dev_data), default=0) + 1
    Bmax = max((len(x) for x in local_b), default=0) + 1
    nCmax = max((len(d[5]) for d in dev_data), default=0) or 1

    a_tiles = np.zeros((n_dev, Amax, tm, tk), np.float32)
    b_tiles = np.zeros((n_dev, Bmax, tk, tn), np.float32)
    send_idx = [np.full((n_dev, caps[r - 1]), Bmax - 1, np.int32)
                for r in range(1, n_dev)]
    a_tid = np.full((n_dev, Wtot), Amax - 1, np.int32)
    # padded local items -> the local zero tile; padded round-r items -> the
    # receive buffer's appended zero slot (index cap_r)
    b_tid = np.empty((n_dev, Wtot), np.int32)
    b_tid[:, : seg_ptr[1]] = Bmax - 1
    for r in range(1, n_dev):
        b_tid[:, seg_ptr[r] : seg_ptr[r + 1]] = caps[r - 1]
    o_tid = np.full((n_dev, Wtot), nCmax, np.int32)
    c_row = np.full((n_dev, nCmax), -1, np.int32)
    c_col = np.full((n_dev, nCmax), -1, np.int32)
    n_c = np.zeros(n_dev, np.int64)

    # recv-slot map: in round r, dst receives src's list in send order
    recv_slot = {}
    for src in range(n_dev):
        for dst in range(n_dev):
            if src == dst:
                continue
            for j, t in enumerate(send_lists[src][dst]):
                recv_slot[(dst, int(t))] = j

    for d in range(n_dev):
        b_tiles[d, : len(local_b[d])] = b_bsr.tiles[local_b[d]]
        for r in range(1, n_dev):
            ids = send_lists[d][(d + r) % n_dev]
            if len(ids):
                send_idx[r - 1][d, : len(ids)] = b_local_slot[ids]
        r0, a_sel, rep, b_ids, o_l, uniq, rounds = dev_data[d]
        a_tiles[d, : len(a_sel)] = a_bsr.tiles[a_sel]
        if len(rep):
            # stable-sort items by source round, then fill each segment
            order = np.argsort(rounds, kind="stable")
            rounds_s = rounds[order]
            rep_s, b_ids_s, o_s = rep[order], b_ids[order], o_l[order]
            for r in range(n_dev):
                mem = np.nonzero(rounds_s == r)[0]
                if not len(mem):
                    continue
                lo = seg_ptr[r]
                a_tid[d, lo : lo + len(mem)] = rep_s[mem]
                o_tid[d, lo : lo + len(mem)] = o_s[mem]
                if r == 0:
                    b_tid[d, lo : lo + len(mem)] = b_local_slot[b_ids_s[mem]]
                else:
                    b_tid[d, lo : lo + len(mem)] = [
                        recv_slot[(d, int(t))] for t in b_ids_s[mem]
                    ]
        n_c[d] = len(uniq)
        c_row[d, : len(uniq)] = (uniq // b_bsr.n_tile_cols).astype(np.int32)
        c_col[d, : len(uniq)] = (uniq % b_bsr.n_tile_cols).astype(np.int32)

    return HaloProblem(
        n_dev=n_dev, tm=tm, tk=tk, tn=tn, caps=caps, seg_ptr=seg_ptr,
        shape=(a.shape[0], b.shape[1]),
        a_tiles=a_tiles, b_tiles=b_tiles, send_idx=send_idx,
        a_tid=a_tid, b_tid=b_tid, o_tid=o_tid,
        c_tile_row=c_row, c_tile_col=c_col,
        row_base=np.array([dp_bounds[d] * tm for d in range(n_dev)], np.int64),
        n_c_tiles=n_c, nCmax=nCmax, halo_tiles_sent=total_sent,
        halo_tiles_padded=n_dev * int(sum(caps)),
    )


def halo_received(problem: HaloProblem, rank: int, r: int) -> np.ndarray:
    """The B tiles ``rank`` receives in round ``r`` (from rank
    ``(rank - r) % D``), f32 [cap_r, tk, tn], read from the problem's own
    arrays: what the exchange delivers."""
    src = (rank - r) % problem.n_dev
    return problem.b_tiles[src][problem.send_idx[r - 1][src]]


def halo_rank(problem: HaloProblem, rank: int, device,
              engine: str = "cached",
              engine_dtype: Optional[torch.dtype] = None,
              chunk: int = 1024
              ) -> Callable[[Callable[[int], torch.Tensor]], torch.Tensor]:
    """``rank``'s body: a call ``body(recv)`` giving its C tiles [nCmax + 1,
    tm, tn] f32 on ``device``.  ``recv(r)`` returns round r's received B
    tiles [cap_r, tk, tn] on ``device`` in the tile dtype, waiting for them
    if it must; the body asks for a round only after the local segment and
    the rounds before it have been enqueued, and never for a round with no
    real items.  Tiles and ids are uploaded here, once.  No collective.

    ``halo_rank(...).b_local`` is the rank's own B tiles on the device,
    which the exchange sends from."""
    dev = check_device(device)
    engine = resolve_engine(engine)
    dtype = tile_dtype(engine, engine_dtype)
    p = problem
    a = torch.from_numpy(np.ascontiguousarray(p.a_tiles[rank])).to(dev, dtype)
    b = torch.from_numpy(np.ascontiguousarray(p.b_tiles[rank])).to(dev, dtype)
    segs = []                                   # (round, its launch)
    for r in range(p.n_dev):
        lo, hi = p.seg_ptr[r], p.seg_ptr[r + 1]
        if not np.any(p.o_tid[rank, lo:hi] != p.nCmax):
            continue
        # a round's ids are checked against its buffer's shape; the tiles
        # themselves come with recv(r)
        tiles = b if r == 0 else torch.empty(
            (p.caps[r - 1], p.tk, p.tn), dtype=dtype, device="meta")
        segs.append((r, prepare_segment(
            a, tiles, p.a_tid[rank, lo:hi], p.b_tid[rank, lo:hi],
            p.o_tid[rank, lo:hi], p.nCmax + 1, engine, chunk)))

    def body(recv: Callable[[int], torch.Tensor]) -> torch.Tensor:
        c = None
        for r, run in segs:
            part = run(b) if r == 0 else run(recv(r))
            c = part if c is None else c.add_(part)
        if c is None:
            c = torch.zeros((p.nCmax + 1, p.tm, p.tn), dtype=torch.float32,
                            device=dev)
        return c

    body.b_local = b
    return body


def spgemm_halo(problem: HaloProblem, mesh=None, device="cuda",
                chunk: int = 1024, engine: str = "auto",
                engine_dtype: Optional[torch.dtype] = None) -> ShardedResult:
    """Execute, this process being one rank of the 1-D ``('dp',)`` mesh
    (None: that mesh over the default process group, of world size D);
    every rank returns the whole result as a ``ShardedResult`` of D panels.

    All D-1 rounds are issued before any compute in one
    ``batch_isend_irecv`` (every rank sends and receives in every round);
    the local segment runs while they are in flight.  ``engine``: 'cached'
    and 'auto' run ``tile_spgemm`` once per round with real items on
    ``engine_dtype`` tiles (bf16 by default: the rounds ship bf16 too),
    summing the rounds' C in f32; 'xla' the plain f32 engine.
    """
    p = problem
    D = p.n_dev
    dev = check_device(device)
    mesh = resolve_mesh(mesh, (D,), ("dp",), dev, "spgemm_halo")
    (rank,) = mesh.get_coordinate()
    body = halo_rank(p, rank, dev, engine, engine_dtype, chunk)
    group = mesh.get_group("dp")
    ops, bufs = [], []
    for r in range(1, D):
        idx = torch.from_numpy(p.send_idx[r - 1][rank].astype(np.int64))
        send = body.b_local.index_select(0, idx.to(dev))
        buf = body.b_local.new_empty((p.caps[r - 1], p.tk, p.tn))
        ops += [dist.P2POp(dist.isend, send,
                           global_rank(mesh, (rank + r) % D), group),
                dist.P2POp(dist.irecv, buf,
                           global_rank(mesh, (rank - r) % D), group)]
        bufs.append(buf)
    works = dist.batch_isend_irecv(ops) if ops else []
    pending = set(range(len(works)))

    def wait(i: int) -> None:
        # a work is waited once: gloo's send work blocks on a second wait
        if i in pending:
            pending.remove(i)
            works[i].wait()

    def recv(r: int) -> torch.Tensor:
        wait(2 * r - 2)
        wait(2 * r - 1)
        return bufs[r - 1]

    c = body(recv)
    for i in sorted(pending):
        wait(i)
    g = gather(c, mesh)
    return ShardedResult(problem=halo_view(p),
                         c_tiles=c_tiles_to_numpy(g)[:, : p.nCmax + 1])


def halo_view(problem: HaloProblem):
    """A halo problem as the ``ShardedResult`` surface reads it: D dp
    panels of one tp rank each."""
    p = problem
    return types.SimpleNamespace(
        n_dp=p.n_dev, n_tp=1, tm=p.tm, tk=p.tk, tn=p.tn, shape=p.shape,
        c_tile_row=p.c_tile_row, c_tile_col=p.c_tile_col,
        row_base=p.row_base, n_c_tiles=p.n_c_tiles)
