"""fqzcomp quality-score codec (CRAM 3.1).

Bitstream parity with ``htscodecs/fqzcomp_qual.c``
(FQZ_VERS=5): stream = varint total length, serialised parameter
block(s), then a range-coded payload driven by adaptive byte models
over a 16-bit context mixing quality history, position, delta and
selector sub-contexts.

The parameter auto-picker (strategy presets + entropy-based READ2 /
quality-average selector tuning) reproduces the reference's float
accumulation order exactly — the chosen parameters are stored in the
stream, so encoder equality requires replaying those heuristics
bit-for-bit.

Throughput note: the per-byte model scan is inherently sequential; the
batched engine (``compress_batch_device``) replays the models on the
host and runs the range-coder chains of all jobs in one CUDA kernel
(``ops/rc_vmem.py``).

The port's own copy of ``htscodecs_tpu/models/fqz.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ops.range_coder import RangeDecoder, RangeEncoder, SimpleModel
from ..utils import varint

FQZ_VERS = 5
FQZ_FREVERSE = 16
FQZ_FREAD2 = 128

GFLAG_MULTI_PARAM = 1
GFLAG_HAVE_STAB = 2
GFLAG_DO_REV = 4

PFLAG_DO_DEDUP = 2
PFLAG_DO_LEN = 4
PFLAG_DO_SEL = 8
PFLAG_HAVE_QMAP = 16
PFLAG_HAVE_PTAB = 32
PFLAG_HAVE_DTAB = 64
PFLAG_HAVE_QTAB = 128

CTX_BITS = 16
CTX_SIZE = 1 << CTX_BITS
QMAX = 256
INT_MAX = 2**31 - 1

import os as _os

from .. import native as _native

def _use_native() -> bool:
    """The native host coders, unless switched off by the environment.
    Asked at call time: the C library is built at first use, not when
    this module is imported."""
    return (_os.environ.get("HTSCODECS_TORCH_NATIVE", "1") != "0"
            and _native.available())


def _pack_gp(gp: "GParams"):
    """Flatten parameter blocks for the native scan kernels."""
    np_ = np
    P = len(gp.p)
    pm_ints = np_.zeros((P, 12), np_.uint32)
    qmaps = np_.zeros((P, 256), np_.uint32)
    qtabs = np_.zeros((P, 256), np_.uint32)
    ptabs = np_.zeros((P, 1024), np_.uint32)
    dtabs = np_.zeros((P, 256), np_.uint32)
    for k, pm in enumerate(gp.p):
        pm_ints[k] = [
            pm.context, pm.pflags, pm.qbits, pm.qshift, pm.qloc, pm.sloc,
            pm.ploc, pm.dloc, pm.max_sym, 1 if pm.fixed_len else 0,
            1 if pm.do_sel else 0, 1 if pm.do_dedup else 0,
        ]
        qmaps[k] = np_.asarray(pm.qmap, np_.int64).astype(np_.uint32)
        qtabs[k] = np_.asarray(pm.qtab, np_.uint32)
        ptabs[k] = np_.asarray([v << pm.ploc for v in pm.ptab], np_.uint32)
        dtabs[k] = np_.asarray([v << pm.dloc for v in pm.dtab], np_.uint32)
    stab = np_.asarray(gp.stab, np_.int64).astype(np_.uint8)
    return pm_ints, qmaps, qtabs, ptabs, dtabs, stab

STRAT_OPTS = [
    #  qb qs pb  ps db ds ql sl  pl  dl  r2 qa
    [10, 5, 4, -1, 2, 1, 0, 14, 10, 14, 0, -1],  # basic (level < 7)
    [8, 5, 7, 0, 0, 0, 0, 14, 8, 14, 1, -1],     # e.g. HiSeq 2000
    [12, 6, 2, 0, 2, 3, 0, 9, 12, 14, 0, 0],     # e.g. MiSeq
    [12, 6, 0, 0, 0, 0, 0, 12, 0, 0, 0, 0],      # e.g. IonTorrent
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],        # custom
]
NSTRATS = len(STRAT_OPTS)

DSQR = [
    0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
]


@dataclass
class Param:
    context: int = 0
    pflags: int = 0
    do_sel: int = 0
    do_dedup: int = 0
    store_qmap: int = 0
    fixed_len: int = 0
    use_qtab: int = 0
    use_dtab: int = 0
    use_ptab: int = 0
    qbits: int = 0
    qloc: int = 0
    pbits: int = 0
    ploc: int = 0
    dbits: int = 0
    dloc: int = 0
    sloc: int = 0
    max_sym: int = 0
    nsym: int = 0
    max_sel: int = 0
    qmap: list = field(default_factory=lambda: [0] * 256)
    qtab: list = field(default_factory=lambda: [0] * 256)
    ptab: list = field(default_factory=lambda: [0] * 1024)
    dtab: list = field(default_factory=lambda: [0] * 256)
    qshift: int = 0
    pshift: int = 0
    dshift: int = 0
    qmask: int = 0
    do_r2: int = 0
    do_qa: int = 0


@dataclass
class GParams:
    vers: int = FQZ_VERS
    gflags: int = 0
    nparam: int = 1
    max_sel: int = 0
    stab: list = field(default_factory=lambda: [0] * 256)
    max_sym: int = 0
    p: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# Double-RLE array serialisation (store_array/read_array)

def store_array(array, size: int) -> bytes:
    """Value array -> per-value run lengths -> RLE of those
    (``fqzcomp_qual.c:106-148``)."""
    tmp = bytearray()
    i = 0
    j = 0
    while i < size:
        run_len = i
        while i < size and array[i] == j:
            i += 1
        run_len = i - run_len
        while True:
            r = min(255, run_len)
            tmp.append(r)
            run_len -= r
            if r != 255:
                break
        j += 1

    out = bytearray()
    last = -1
    jj = 0
    k = len(tmp)
    while jj < k:
        v = tmp[jj]
        jj += 1
        out.append(v)
        if v == last:
            n = jj
            while jj < k and tmp[jj] == last:
                jj += 1
            out.append(jj - n)
        else:
            last = v
    return bytes(out)


def read_array(buf, pos: int, end: int, size: int):
    """Inverse of store_array.  Returns (array list, new pos) or
    (None, pos) on error (``fqzcomp_qual.c:150-194``)."""
    size = min(1024, size)
    R = []
    z = 0
    last = -1
    i = pos
    while z < size and i < end:
        run = buf[i]
        R.append(run)
        z += run
        if run == last:
            i += 1
            if i >= end:
                return None, pos
            copy = buf[i]
            z += run * copy
            while copy and z < size and len(R) < 1024:
                R.append(run)
                copy -= 1
        if len(R) >= 1024:
            return None, pos
        last = run
        i += 1
    nb = i - pos

    array = [0] * size
    r_max = len(R)
    zz = 0
    j = 0
    val = 0
    while j < size:
        run_len = 0
        if zz >= r_max:
            return None, pos
        while True:
            part = R[zz]
            zz += 1
            run_len += part
            if not (part == 255 and zz < r_max):
                break
        if part == 255:
            return None, pos
        while run_len and j < size:
            run_len -= 1
            array[j] = val
            j += 1
        val += 1
    return array, pos + nb


# ---------------------------------------------------------------------------
# Statistics pass (fqz_qual_stats)

def qual_stats(lens, flags, data: np.ndarray, pm: Param, qhist, one_param: int):
    """Histogram/dedup/selector analysis (``fqzcomp_qual.c:418-693``).

    ``flags`` is mutated in place (selector bits packed into bits 16+),
    matching the reference's in-place behaviour.
    """
    NP = 128
    in_size = len(data)
    num_records = len(lens)

    qhistb = np.zeros((NP, 256), dtype=np.int64)
    qhist1 = np.zeros((NP, 256), dtype=np.int64)
    qhist2 = np.zeros((NP, 256), dtype=np.int64)
    t1 = np.zeros(NP, dtype=np.int64)
    t2 = np.zeros(NP, dtype=np.int64)
    avg = np.zeros(2560, dtype=np.int64)

    max_sel = 0
    has_r2 = 0
    fl_np = np.asarray(flags[:num_records], np.int64)
    sel_np = fl_np >> 16
    if one_param >= 0:
        selmask = sel_np == one_param
    else:
        selmask = np.ones(num_records, bool)
    num_rec = int(selmask.sum())
    if num_rec:
        max_sel = int(sel_np[selmask].max())
        has_r2 = 1 if (fl_np[selmask] & FQZ_FREAD2).any() else 0

    # Vectorised fast path (default single-param analysis): the
    # per-record bookkeeping loop stays scalar for exactness, but all
    # histogram accumulation collapses into global bincounts over
    # per-position index arrays (5 np.add.at calls per record was the
    # dominant fqz encode cost).
    fast = one_param < 0
    seg_bounds = []          # (start, len, reclen, dir2, rec) per segment
    avg_qual = [0] * (num_records + 1)
    do_dedup = 0
    last_len = 0
    rec = 0
    i = 0
    pos_all = dat_all = dir_all = rec_all = None
    nat = nat_hb = nat_h2 = None
    if fast and num_records and in_size:
        ls = np.asarray(lens[:num_records], np.int64)
        st = np.zeros(num_records, np.int64)
        np.cumsum(ls[:-1], out=st[1:])
        if (ls > 0).all() and int(ls.sum()) <= in_size:
            # ---- fully vectorised single-param analysis ----
            tail = in_size - int(ls.sum())
            nseg = num_records + (1 if tail > 0 else 0)
            ls_e = ls
            st_e = st
            if tail > 0:
                ls_e = np.append(ls, tail)
                st_e = np.append(st, in_size - tail)
            d2f = np.zeros(nseg, np.int64)
            d2f[:num_records] = (np.asarray(flags[:num_records], np.int64)
                                 & FQZ_FREAD2) != 0
            # histograms + sums + dedup in one native pass when
            # available; the numpy fallback builds per-position arrays
            nat1 = (_native.fqz_stats1(data, st_e, ls_e,
                                       (d2f != 0).astype(np.uint8),
                                       nrec=num_records)
                    if _use_native() else None)
            if nat1 is not None:
                nat_hb, nat_h2, sums_e, dd = nat1
                do_dedup += dd
                nat = (st_e, ls_e, nseg)
            else:
                d32 = data.astype(np.int32)
                sums_e = np.add.reduceat(d32, st_e, dtype=np.int64)
                # dedup: adjacent records of equal length, bytewise
                # equal — shifted-compare + cumsum, one data pass per
                # distinct length
                cand = np.flatnonzero((ls[1:] == ls[:-1]) & (st[1:] > 0)) + 1
                if len(cand):
                    for Lv in np.unique(ls[cand]):
                        L = int(Lv)
                        sel = cand[ls[cand] == L]
                        ne = (data[L:] != data[:-L]).astype(np.int64)
                        c = np.cumsum(ne)
                        w = st[sel] - L
                        hi = c[w + L - 1]
                        lo = np.where(w > 0, c[np.maximum(w - 1, 0)], 0)
                        do_dedup += int((hi == lo).sum())
                # per-position arrays for the histogram passes
                rec_all = np.repeat(np.arange(nseg, dtype=np.int32),
                                    ls_e.astype(np.int64))
                st32 = st_e.astype(np.int32)
                ls32 = ls_e.astype(np.int32)
                within = np.arange(in_size, dtype=np.int32) - st32[rec_all]
                pos_all = (ls32[rec_all] - within) & (NP - 1)
                dat_all = d32
                dir_all = d2f[rec_all] != 0
            # avg_qual: identical float op order per element
            tots = ((sums_e * 10.0) / ls_e + 0.5).astype(np.int64)
            k = min(nseg, num_records + 1)
            avg_qual[:k] = tots[:k].tolist()
            avg += np.bincount(np.minimum(2559, tots), minlength=2560)
            rec = nseg
            i = in_size
    while i < in_size:
        if one_param >= 0 and rec < num_records and (flags[rec] >> 16) != one_param:
            avg_qual[rec] = 0
            i += lens[rec]
            rec += 1
            continue
        if rec < num_records:
            j = lens[rec]
            dir2 = 1 if flags[rec] & FQZ_FREAD2 else 0
            if i > 0 and j == last_len and \
                    data[i - last_len:i].tobytes() == data[i:i + j].tobytes():
                do_dedup += 1
        else:
            j = in_size - i
            dir2 = 0
        last_len = j

        n = min(j, in_size - i)
        tot = int(data[i:i + n].sum())
        seg_bounds.append((i, n, j, dir2, rec))
        i += n

        tot = int((tot * 10.0) / last_len + 0.5) if last_len else 0
        if rec < len(avg_qual):
            avg_qual[rec] = tot
        avg[min(2559, tot)] += 1
        rec += 1

    # global accumulation over all processed segments; position index
    # is bytes-remaining (j - offset) & 127, with j the RECORD length
    if pos_all is None and seg_bounds:
        pos_all = np.empty(sum(n for _s, n, _j, _d, _r in seg_bounds),
                           np.int64)
        dat_all = np.empty(len(pos_all), np.int64)
        dir_all = np.empty(len(pos_all), bool)
        rec_all = np.empty(len(pos_all), np.int64)
        o = 0
        for s, n, j, d2, r in seg_bounds:
            pos_all[o:o + n] = (np.int64(j)
                                - np.arange(n, dtype=np.int64)) & (NP - 1)
            dat_all[o:o + n] = data[s:s + n]
            dir_all[o:o + n] = bool(d2)
            rec_all[o:o + n] = r
            o += n
    key = None
    if nat is not None:
        hb, h2 = nat_hb, nat_h2
        qhistb += hb
        qhist += hb.sum(axis=0)
        qhist2 += h2
        t2 += h2.sum(axis=1)
        h1 = hb - h2
        qhist1 += h1
        t1 += h1.sum(axis=1)
    elif pos_all is not None:
        # one bincount for the (pos, sym) grid; the split/marginal
        # histograms derive from it instead of extra full-data passes
        key = pos_all * 256 + dat_all
        hb = np.bincount(key, minlength=NP * 256).reshape(NP, 256)
        qhistb += hb
        qhist += hb.sum(axis=0)
        if dir_all.any():
            h2 = np.bincount(key[dir_all],
                             minlength=NP * 256).reshape(NP, 256)
        else:
            h2 = np.zeros((NP, 256), np.int64)
        qhist2 += h2
        t2 += h2.sum(axis=1)
        h1 = hb - h2
        qhist1 += h1
        t1 += h1.sum(axis=1)

    pm.do_dedup = 1 if (rec + 1) // (do_dedup + 1) < 500 else 0

    pm.max_sym = 0
    pm.nsym = 0
    for s in range(256):
        if qhist[s]:
            pm.max_sym = s
            pm.nsym += 1

    # Auto tune: average-quality selector
    if pm.do_qa != 0:
        qf0 = 0.2 if pm.nsym > 8 else 0.05
        qf1 = 0.5 if pm.nsym > 8 else 0.22
        qf2 = 0.8 if pm.nsym > 8 else 0.60

        total = 0
        i = 0
        while i < 2560:
            total += int(avg[i])
            if total > qf0 * num_rec:
                break
            avg[i] = 0
            i += 1
        while i < 2560:
            total += int(avg[i])
            if total > qf1 * num_rec:
                break
            avg[i] = 1
            i += 1
        while i < 2560:
            total += int(avg[i])
            if total > qf2 * num_rec:
                break
            avg[i] = 2
            i += 1
        while i < 2560:
            avg[i] = 3
            i += 1

        qbin4 = np.zeros((4, NP, 256), dtype=np.int64)
        qbin2 = np.zeros((2, NP, 256), dtype=np.int64)
        qbin1 = np.zeros((NP, 256), dtype=np.int64)
        qcnt4 = np.zeros((4, NP), dtype=np.int64)
        qcnt2 = np.zeros((2, NP), dtype=np.int64)
        qcnt1 = np.zeros(NP, dtype=np.int64)

        # same processed segments as the main pass; per-record bin
        # labels broadcast to positions, then global bincounts
        k4 = None
        if nat is not None:
            st_e, ls_e, nseg = nat
            aq = np.asarray(avg_qual + [0], np.int64)
            qb4_rec = avg[np.minimum(2559, aq)].astype(np.uint8)
            labels = qb4_rec[np.minimum(np.arange(nseg), len(aq) - 1)]
            k4 = _native.fqz_stats2(data, st_e, ls_e, labels)
        elif pos_all is not None:
            aq = np.asarray(avg_qual + [0], np.int64)
            qb4_rec = avg[np.minimum(2559, aq)].astype(np.int32)
            qb4_all = qb4_rec[np.minimum(rec_all, len(aq) - 1)]
            # one finest-grained bincount; the 2-bin/1-bin grids and
            # all counts are its marginals
            k4 = np.bincount(
                qb4_all * (NP * 256) + key,
                minlength=4 * NP * 256).reshape(4, NP, 256)
        if k4 is not None:
            qbin4 += k4
            qcnt4 += k4.sum(axis=2)
            k2 = k4.reshape(2, 2, NP, 256).sum(axis=1)
            qbin2 += k2
            qcnt2 += k2.sum(axis=2)
            qbin1 += k4.sum(axis=0)
            qcnt1 += k4.sum(axis=(0, 2))

        e1 = e2 = e4 = 0.0
        # visit only (j, s) cells where any bin is non-zero, in the same
        # row-major order as the dense loop: float accumulation order is
        # part of the bitstream contract (the e-values pick parameters),
        # so the scalar math.log arithmetic is kept verbatim; cells are
        # pulled into plain lists first (numpy scalar indexing in the
        # loop was the dominant encode cost at small blocks)
        nzmask = (qbin1 != 0) | (qbin2[0] != 0) | (qbin2[1] != 0) \
            | (qbin4 != 0).any(axis=0)
        jj, ss = np.nonzero(nzmask)
        q1v = qbin1[jj, ss].tolist()
        c1v = qcnt1[jj].astype(np.float64).tolist()
        q2v = [qbin2[b][jj, ss].tolist() for b in range(2)]
        c2v = [qcnt2[b][jj].astype(np.float64).tolist() for b in range(2)]
        q4v = [qbin4[b][jj, ss].tolist() for b in range(4)]
        c4v = [qcnt4[b][jj].astype(np.float64).tolist() for b in range(4)]
        log = math.log
        for k in range(len(jj)):
            v = q1v[k]
            if v:
                e1 += v * log(v / c1v[k])
            v = q2v[0][k]
            if v:
                e2 += v * log(v / c2v[0][k])
            v = q2v[1][k]
            if v:
                e2 += v * log(v / c2v[1][k])
            for b in range(4):
                v = q4v[b][k]
                if v:
                    e4 += v * log(v / c4v[b][k])
        e1 /= -math.log(2) / 8
        e2 /= -math.log(2) / 8
        e4 /= -math.log(2) / 8

        qm = 1 if pm.do_qa > 0 else 0.98
        aqv = np.minimum(2559, np.asarray(avg_qual[:num_records], np.int64))
        if (pm.do_qa == -1 or pm.do_qa >= 4) and \
                e4 + num_records // 4 < e2 * qm + num_records // 8 and \
                e4 + num_records // 4 < e1 * qm:
            newf = (np.asarray(flags[:num_records], np.int64)
                    | (avg[aqv] << 16))
            flags[:num_records] = newf.tolist()
            pm.do_sel = 1
            max_sel = 3
        elif (pm.do_qa == -1 or pm.do_qa >= 2) and e2 + num_records // 8 < e1 * qm:
            newf = (np.asarray(flags[:num_records], np.int64)
                    | ((avg[aqv] >> 1) << 16))
            flags[:num_records] = newf.tolist()
            pm.do_sel = 1
            max_sel = 1

        if pm.do_qa == -1:
            if pm.pbits > 0 and pm.dbits > 0:
                pm.sloc = pm.dloc - 1
                pm.pbits -= 1
                pm.dbits -= 1
                pm.dloc += 1
            elif pm.dbits >= 2:
                pm.sloc = pm.dloc
                pm.dbits -= 2
                pm.dloc += 2
            elif pm.qbits >= 2:
                pm.qbits -= 2
                pm.ploc -= 2
                pm.sloc = 16 - 2 - pm.do_r2
                if pm.qbits == 6 and pm.qshift == 5:
                    pm.qbits -= 1
            pm.do_qa = 4

    # Auto tune: READ1 vs READ2 split
    if has_r2 or pm.do_r2:
        e1 = e2 = 0.0
        nzmask = (qhistb != 0) & ((t1 != 0) & (t2 != 0))[:, None]
        for j, s in zip(*np.nonzero(nzmask)):
            e1 -= qhistb[j][s] * math.log(qhistb[j][s] / float(t1[j] + t2[j]))
            if qhist1[j][s]:
                e2 -= qhist1[j][s] * math.log(qhist1[j][s] / float(t1[j]))
            if qhist2[j][s]:
                e2 -= qhist2[j][s] * math.log(qhist2[j][s] / float(t2[j]))
        e1 /= math.log(2) * 8
        e2 /= math.log(2) * 8

        qm = 1 if pm.do_r2 > 0 else 0.95
        if e2 + (8 + num_records // 8) < e1 * qm:
            for rec in range(num_records):
                if one_param >= 0 and (flags[rec] >> 16) != one_param:
                    continue
                sel = flags[rec] >> 16
                flags[rec] = (flags[rec] & 0xFFFF) | (
                    ((sel * 2) + 1) << 16 if flags[rec] & FQZ_FREAD2 else ((sel * 2) + 0) << 16
                )
                if max_sel < (flags[rec] >> 16):
                    max_sel = flags[rec] >> 16

    if max_sel > 0:
        pm.do_sel = 1
        pm.max_sel = max_sel


# ---------------------------------------------------------------------------
# Parameter pick / store / read

def pick_parameters(vers: int, strat: int, lens, flags, data: np.ndarray) -> GParams:
    qhist = [0] * 256
    if strat >= NSTRATS:
        strat = NSTRATS - 1

    gp = GParams()
    gp.p = [Param()]
    gp.nparam = 1
    gp.max_sel = 0
    if vers == 3:
        gp.gflags |= GFLAG_DO_REV

    pm = gp.p[0]
    (pm.qbits, pm.qshift, pm.pbits, pm.pshift, pm.dbits, pm.dshift,
     pm.qloc, pm.sloc, pm.ploc, pm.dloc, pm.do_r2, pm.do_qa) = STRAT_OPTS[strat]

    in_size = len(data)
    # Validity-check input lengths against the buffer.
    tlen = 0
    for i in range(len(lens)):
        if tlen + lens[i] > in_size:
            lens[i] = in_size - tlen
        tlen += lens[i]
    if len(lens) > 0 and tlen < in_size:
        lens[-1] += in_size - tlen

    qhist_np = np.zeros(256, dtype=np.int64)
    qual_stats(lens, flags, data, pm, qhist_np, -1)
    qhist = qhist_np

    pm.store_qmap = 1 if (pm.nsym <= 8 and pm.nsym * 2 < pm.max_sym) else 0

    first_len = lens[0] if len(lens) else 0
    fixed = all(l == first_len for l in lens)
    pm.fixed_len = 1 if fixed else 0
    pm.use_qtab = 0

    if strat < NSTRATS - 1:
        if pm.pshift < 0:
            pm.pshift = max(0, int(math.log(float(lens[0]) / (1 << pm.pbits)) / math.log(2) + 0.5))
        if pm.nsym <= 4:
            pm.qshift = 2
            if in_size < 5000000:
                pm.pbits = 2
                pm.pshift = 5
        elif pm.nsym <= 8:
            pm.qbits = min(pm.qbits, 9)
            pm.qshift = 3
            if in_size < 5000000:
                pm.qbits = 6
        if in_size < 300000:
            pm.qbits = pm.qshift
            pm.dbits = 2

    _finish_param(pm, qhist, gp)

    gp.max_sel = 0
    if pm.do_sel:
        gp.max_sel = 1
        gp.gflags |= GFLAG_HAVE_STAB
    if gp.max_sel:
        mx = 0
        for f in flags:
            if mx < (f >> 16):
                mx = f >> 16
        gp.max_sel = mx

    return gp


def _finish_param(pm: Param, qhist, gp: GParams) -> None:
    """Shared tail of parameter derivation: dsqr clamping, qmap/qtab/
    ptab/dtab table production, pflags assembly."""
    dsqr = list(DSQR)
    for i in range(len(dsqr)):
        if dsqr[i] > (1 << pm.dbits) - 1:
            dsqr[i] = (1 << pm.dbits) - 1

    if pm.store_qmap:
        j = 0
        for i in range(256):
            if qhist[i]:
                pm.qmap[i] = j
                j += 1
            else:
                pm.qmap[i] = INT_MAX
        pm.max_sym = pm.nsym
    else:
        pm.nsym = 255
        for i in range(256):
            pm.qmap[i] = i
    if gp.max_sym < pm.max_sym:
        gp.max_sym = pm.max_sym

    if pm.qbits:
        for i in range(256):
            pm.qtab[i] = i
    pm.qmask = (1 << pm.qbits) - 1

    if pm.pbits:
        for i in range(1024):
            pm.ptab[i] = min((1 << pm.pbits) - 1, i >> pm.pshift)

    if pm.dbits:
        for i in range(256):
            pm.dtab[i] = dsqr[min(len(dsqr) - 1, i >> pm.dshift)]

    pm.use_ptab = 1 if pm.pbits > 0 else 0
    pm.use_dtab = 1 if pm.dbits > 0 else 0

    pm.pflags = (
        (PFLAG_HAVE_QTAB if pm.use_qtab else 0)
        | (PFLAG_HAVE_DTAB if pm.use_dtab else 0)
        | (PFLAG_HAVE_PTAB if pm.use_ptab else 0)
        | (PFLAG_DO_SEL if pm.do_sel else 0)
        | (PFLAG_DO_LEN if pm.fixed_len else 0)
        | (PFLAG_DO_DEDUP if pm.do_dedup else 0)
        | (PFLAG_HAVE_QMAP if pm.store_qmap else 0)
    )


def manual_parameters(hex_params: list[int], lens, flags, data: np.ndarray) -> GParams:
    """Equivalent of the test tool's -x option
    (``tests/fqzcomp_qual_test.c:88-228``): 12-nibble parameter words,
    multi-param capable."""
    gp = GParams()
    gp.nparam = len(hex_params)
    gp.gflags = GFLAG_MULTI_PARAM | GFLAG_HAVE_STAB
    gp.stab = [0] * 256
    gp.max_sel = 0
    gp.max_sym = 0
    gp.p = []

    for p, st in enumerate(hex_params):
        pm = Param()
        pm.do_qa = st & 15; st >>= 4
        pm.do_r2 = st & 15; st >>= 4
        pm.dloc = st & 15; st >>= 4
        pm.ploc = st & 15; st >>= 4
        pm.sloc = st & 15; st >>= 4
        pm.qloc = st & 15; st >>= 4
        pm.dshift = st & 15; st >>= 4
        pm.dbits = st & 15; st >>= 4
        pm.pshift = st & 15; st >>= 4
        pm.pbits = st & 15; st >>= 4
        pm.qshift = st & 15; st >>= 4
        pm.qbits = st & 15; st >>= 4

        qhist = np.zeros(256, dtype=np.int64)
        qual_stats(lens, flags, data, pm, qhist, p)
        max_sel = pm.max_sel

        for i in range(gp.max_sel, gp.max_sel + max_sel + 1):
            gp.stab[i] = p
        gp.max_sel += max_sel + 1

        pm.fixed_len = 1 if pm.fixed_len > 0 else 0
        pm.use_qtab = 0
        pm.store_qmap = 1 if pm.nsym <= 8 else 0

        _finish_param(pm, qhist, gp)
        gp.p.append(pm)

    for i in range(gp.max_sel, 256):
        gp.stab[i] = gp.stab[gp.max_sel - 1]
    return gp


def store_parameters(gp: GParams) -> bytes:
    out = bytearray()
    out.append(gp.vers)
    out.append(gp.gflags)
    if gp.gflags & GFLAG_MULTI_PARAM:
        out.append(gp.nparam)
    if gp.gflags & GFLAG_HAVE_STAB:
        out.append(gp.max_sel)
        out += store_array(gp.stab, 256)
    for pm in gp.p:
        out.append(pm.context & 0xFF)
        out.append((pm.context >> 8) & 0xFF)
        out.append(pm.pflags & 0xFF)
        out.append(pm.max_sym & 0xFF)
        out.append(((pm.qbits << 4) | pm.qshift) & 0xFF)
        out.append(((pm.qloc << 4) | pm.sloc) & 0xFF)
        out.append(((pm.ploc << 4) | pm.dloc) & 0xFF)
        if pm.store_qmap:
            for i in range(256):
                if pm.qmap[i] != INT_MAX:
                    out.append(i)
        if pm.qbits and pm.use_qtab:
            out += store_array(pm.qtab, 256)
        if pm.pbits and pm.use_ptab:
            out += store_array(pm.ptab, 1024)
        if pm.dbits and pm.use_dtab:
            out += store_array(pm.dtab, 256)
    return bytes(out)


def read_parameters(buf, pos: int, end: int) -> tuple[GParams | None, int]:
    if end - pos < 10:
        return None, pos
    gp = GParams()
    gp.vers = buf[pos]; pos += 1
    if gp.vers != FQZ_VERS:
        return None, pos
    gp.gflags = buf[pos]; pos += 1
    if gp.gflags & GFLAG_MULTI_PARAM:
        gp.nparam = buf[pos]; pos += 1
    else:
        gp.nparam = 1
    if gp.nparam <= 0:
        return None, pos
    gp.max_sel = gp.nparam if gp.nparam > 1 else 0
    if gp.gflags & GFLAG_HAVE_STAB:
        gp.max_sel = buf[pos]; pos += 1
        arr, pos = read_array(buf, pos, end, 256)
        if arr is None:
            return None, pos
        gp.stab = arr
    else:
        gp.stab = [min(i, gp.nparam - 1) for i in range(256)]

    gp.max_sym = 0
    gp.p = []
    for _ in range(gp.nparam):
        pm, pos = _read_param1(buf, pos, end)
        if pm is None:
            return None, pos
        gp.p.append(pm)
        if gp.max_sym < pm.max_sym:
            gp.max_sym = pm.max_sym
    return gp, pos


def _read_param1(buf, pos: int, end: int) -> tuple[Param | None, int]:
    if end - pos < 7:
        return None, pos
    pm = Param()
    pm.context = buf[pos] | (buf[pos + 1] << 8); pos += 2
    pm.pflags = buf[pos]; pos += 1
    pm.use_qtab = pm.pflags & PFLAG_HAVE_QTAB
    pm.use_dtab = pm.pflags & PFLAG_HAVE_DTAB
    pm.use_ptab = pm.pflags & PFLAG_HAVE_PTAB
    pm.do_sel = pm.pflags & PFLAG_DO_SEL
    pm.fixed_len = pm.pflags & PFLAG_DO_LEN
    pm.do_dedup = pm.pflags & PFLAG_DO_DEDUP
    pm.store_qmap = pm.pflags & PFLAG_HAVE_QMAP
    pm.max_sym = buf[pos]; pos += 1
    pm.qbits = buf[pos] >> 4
    pm.qmask = (1 << pm.qbits) - 1
    pm.qshift = buf[pos] & 15; pos += 1
    pm.qloc = buf[pos] >> 4
    pm.sloc = buf[pos] & 15; pos += 1
    pm.ploc = buf[pos] >> 4
    pm.dloc = buf[pos] & 15; pos += 1

    if pm.store_qmap:
        pm.qmap = [INT_MAX] * 256
        if pos + pm.max_sym > end:
            return None, pos
        for i in range(pm.max_sym):
            pm.qmap[i] = buf[pos]; pos += 1
    else:
        pm.qmap = list(range(256))

    if pm.qbits:
        if pm.use_qtab:
            arr, pos = read_array(buf, pos, end, 256)
            if arr is None:
                return None, pos
            pm.qtab = arr
        else:
            pm.qtab = list(range(256))

    if pm.use_ptab:
        arr, pos = read_array(buf, pos, end, 1024)
        if arr is None:
            return None, pos
        pm.ptab = arr
    else:
        pm.ptab = [0] * 1024

    if pm.use_dtab:
        arr, pos = read_array(buf, pos, end, 256)
        if arr is None:
            return None, pos
        pm.dtab = arr
    else:
        pm.dtab = [0] * 256

    return pm, pos


# ---------------------------------------------------------------------------
# Debug dumpers (``fqzcomp_qual.c:226-307`` dump_params/dump_table/
# dump_map): human-readable parameter-block rendering for debugging
# picker/serialisation faults.  Output format mirrors the reference.

def _dump_table(tab, name, out):
    parts, i, n = [], 0, len(tab)
    while i < n:
        j = i
        while j + 1 < n and tab[j + 1] == tab[j]:
            j += 1
        if j > i:                              # constant run
            parts.append(f"{tab[i]} x {j - i + 1}")
            i = j + 1
            continue
        k = i
        while k + 1 < n and tab[k + 1] == tab[k] + 1:
            k += 1
        if k > i + 1:                          # ascending run
            # keep trailing equal values out of the ramp (0..2 3x3)
            if k + 1 < n and tab[k + 1] == tab[k]:
                k -= 1
            parts.append(f"{tab[i]}..{tab[k]}")
            i = k + 1
            continue
        parts.append(str(tab[i]))
        i += 1
    print(f"\t{name}\t{{{', '.join(parts)}}}", file=out)


def _dump_map(map_, name, out):
    ent = [f"{i}={v}" for i, v in enumerate(map_) if v != INT_MAX]
    print(f"\t{name}\t{{{', '.join(ent)}}}", file=out)


def dump_params(gp: GParams, out=None) -> None:
    """Render a parameter set like the reference's ``dump_params``."""
    import sys
    out = out or sys.stderr
    print("Global params = {", file=out)
    print(f"\tvers\t{gp.vers}", file=out)
    print(f"\tgflags\t0x{gp.gflags:02x}", file=out)
    print(f"\tnparam\t{gp.nparam}", file=out)
    print(f"\tmax_sel\t{gp.max_sel}", file=out)
    print(f"\tmax_sym\t{gp.max_sym}", file=out)
    if gp.gflags & GFLAG_HAVE_STAB:
        _dump_table(gp.stab, "stab", out)
    print("}", file=out)
    for i, pm in enumerate(gp.p):
        print(f"\nParam[{i}] = {{", file=out)
        print(f"\tcontext\t0x{pm.context:04x}", file=out)
        print(f"\tpflags\t0x{pm.pflags:02x}", file=out)
        print(f"\tmax_sym\t{pm.max_sym}", file=out)
        print(f"\tqbits\t{pm.qbits}", file=out)
        print(f"\tqshift\t{pm.qshift}", file=out)
        print(f"\tqloc\t{pm.qloc}", file=out)
        print(f"\tsloc\t{pm.sloc}", file=out)
        print(f"\tploc\t{pm.ploc}", file=out)
        print(f"\tdloc\t{pm.dloc}", file=out)
        if pm.pflags & PFLAG_HAVE_QMAP:
            _dump_map(pm.qmap, "qmap", out)
        if pm.pflags & PFLAG_HAVE_QTAB:
            _dump_table(pm.qtab, "qtab", out)
        if pm.pflags & PFLAG_HAVE_PTAB:
            _dump_table(pm.ptab, "ptab", out)
        if pm.pflags & PFLAG_HAVE_DTAB:
            _dump_table(pm.dtab, "dtab", out)
        print("}", file=out)


# ---------------------------------------------------------------------------
# Models and the per-byte scan

class _Models:
    """Lazy per-context quality models (65536 contexts, instantiated on
    first touch — identical behaviour, far less memory)."""

    def __init__(self, gp: GParams):
        self._max_sym = gp.max_sym + 1
        self._qual: dict[int, SimpleModel] = {}
        self.len = [SimpleModel(256, 256) for _ in range(4)]
        self.revcomp = SimpleModel(2, 2)
        self.dup = SimpleModel(2, 2)
        self.sel = SimpleModel(256, gp.max_sel + 1) if gp.max_sel > 0 else None

    def qual(self, ctx: int) -> SimpleModel:
        m = self._qual.get(ctx)
        if m is None:
            m = SimpleModel(QMAX, self._max_sym)
            self._qual[ctx] = m
        return m


def _update_ctx(pm: Param, state: dict, q: int) -> int:
    last = 0
    state["qctx"] = ((state["qctx"] << pm.qshift) + pm.qtab[q]) & 0xFFFFFFFF
    last += (state["qctx"] & pm.qmask) << pm.qloc
    last += pm.ptab[min(1023, state["p"])]
    last += pm.dtab[min(255, state["delta"])]
    last += state["s"] << pm.sloc
    state["delta"] += 1 if state["prevq"] != q else 0
    state["prevq"] = q
    state["p"] -= 1
    return last & (CTX_SIZE - 1)


def _encode_setup(data, lens, flags, vers: int, strat: int,
                  gp: GParams | None):
    """What every encode path does before the per-byte scan: private
    copies of the inputs, the parameter pick, the stream header (varint
    length + parameter block) and, under GFLAG_DO_REV, the reversal of
    the flagged records.  Returns (data, lens, flags, the caller's own
    flag list or None, gp, header bytearray)."""
    data = (np.frombuffer(bytes(data), dtype=np.uint8).copy()
            if not isinstance(data, np.ndarray) else data.copy())
    in_size = len(data)
    caller_flags = flags if isinstance(flags, list) else None
    lens = list(lens)
    flags = list(flags) if flags is not None else [0] * len(lens)

    if gp is None:
        gp = pick_parameters(vers, strat, lens, flags, data)

    out = bytearray()
    varint.put_uint(out, in_size)
    out += store_parameters(gp)

    if gp.gflags & GFLAG_DO_REV:
        i = 0
        rec = 0
        while i < in_size:
            ln = lens[rec] if rec < len(lens) - 1 else in_size - i
            if flags[rec] & FQZ_FREVERSE:
                data[i:i + ln] = data[i:i + ln][::-1]
            i += ln
            rec += 1
    return data, lens, flags, caller_flags, gp, out


def compress(data, lens, flags=None, vers: int = 4, strat: int = 0,
             gp: GParams | None = None) -> bytes:
    """Compress concatenated quality strings.

    ``lens``: per-record lengths; ``flags``: per-record BAM-style flags
    (FQZ_FREVERSE=16, FQZ_FREAD2=128, selector in bits 16+).
    """
    data, lens, flags, caller_flags, gp, out = _encode_setup(
        data, lens, flags, vers, strat, gp)
    in_size = len(data)

    # Pre-shift tables (the stored copies keep original values).
    shifted = []
    for pm in gp.p:
        ptab = [v << pm.ploc for v in pm.ptab]
        dtab = [v << pm.dloc for v in pm.dtab]
        shifted.append((ptab, dtab))

    if _use_native():
        payload = _native.fqz_enc_scan(
            data, np.asarray(lens, np.uint32), np.asarray(flags, np.uint32),
            gp, _pack_gp(gp))
        if payload is not None:
            if caller_flags is not None:
                for r in range(len(caller_flags)):
                    caller_flags[r] &= 0xFFFF
            return bytes(out) + payload

    model = _Models(gp)
    rc = RangeEncoder()

    state = {"qctx": 0, "p": 0, "delta": 0, "prevq": 0, "s": 0}
    first_len = 1
    last = 0
    last_len = 0
    rec = 0
    pm = gp.p[0]
    ptab, dtab = shifted[0]
    dlist = data.tolist()
    num_records = len(lens)

    i = 0
    while i < in_size:
        if state["p"] == 0:
            if pm.do_sel or (gp.gflags & GFLAG_MULTI_PARAM):
                state["s"] = (flags[rec] >> 16) if rec < num_records else 0
                model.sel.encode(rc, state["s"])
            else:
                state["s"] = 0
            x = gp.stab[state["s"]] if (gp.gflags & GFLAG_HAVE_STAB) else state["s"]
            pm = gp.p[x]
            ptab, dtab = shifted[x]

            ln = lens[rec]
            if not pm.fixed_len or first_len:
                model.len[0].encode(rc, ln & 0xFF)
                model.len[1].encode(rc, (ln >> 8) & 0xFF)
                model.len[2].encode(rc, (ln >> 16) & 0xFF)
                model.len[3].encode(rc, (ln >> 24) & 0xFF)
                first_len = 0

            if gp.gflags & GFLAG_DO_REV:
                model.revcomp.encode(rc, 1 if flags[rec] & FQZ_FREVERSE else 0)

            rec += 1
            state["p"] = ln
            state["delta"] = 0
            state["qctx"] = 0
            state["prevq"] = 0
            last = pm.context

            if pm.do_dedup:
                if i and ln == last_len and dlist[i - last_len:i] == dlist[i:i + ln]:
                    model.dup.encode(rc, 1)
                    i += ln
                    state["p"] = 0
                    continue
                model.dup.encode(rc, 0)
                last_len = ln

        q = dlist[i]
        qm = pm.qmap[q]
        model.qual(last).encode(rc, qm)
        # inline _update_ctx with pre-shifted tables
        state["qctx"] = (state["qctx"] << pm.qshift) + pm.qtab[qm]
        last = (((state["qctx"] & pm.qmask) << pm.qloc)
                + ptab[min(1023, state["p"])]
                + dtab[min(255, state["delta"])]
                + (state["s"] << pm.sloc)) & (CTX_SIZE - 1)
        if state["prevq"] != qm:
            state["delta"] += 1
        state["prevq"] = qm
        state["p"] -= 1
        i += 1

    # The reference strips the selector abuse of the caller's flags
    # after compression (fqzcomp_qual.c:1142-1144); mirror that so a
    # slice can be reused (e.g. repeated manual_parameters calls).
    if caller_flags is not None:
        for r in range(len(caller_flags)):
            caller_flags[r] &= 0xFFFF

    return bytes(out) + rc.finish()


def _replay_job(job, vers: int):
    """Header, (acc, f, tot) triples and the caller's flag list of one
    job, or None when the native replay refuses it."""
    data, lens, *rest = job
    flags = rest[0] if len(rest) > 0 else None
    strat = rest[1] if len(rest) > 1 else 0
    data, lens, flags, caller_flags, gp, out = _encode_setup(
        data, lens, flags, vers, strat, None)
    tri = _native.fqz_enc_replay(
        data, np.asarray(lens, np.uint32),
        np.asarray(flags, np.uint32), gp, _pack_gp(gp))
    if tri is None:
        return None
    return bytes(out), tri, caller_flags


def compress_batch_device(jobs, vers: int = 4, device="cuda",
                          pmap=None) -> list[bytes] | None:
    """Batched fqz encode through the device range coder.

    The serial per-byte work splits in two (reference loop:
    fqzcomp_qual.c:1040-1113): the context/model walk replays on the
    host emitting one (acc, f, tot) triple per coded event (native
    fqz_enc_replay: the 65536-context model arena is a pointer-chase
    over tens of megabytes per job), and the carry-counting range-coder
    chains of all jobs run in one launch of the ``rc_enc`` CUDA kernel
    (ops/rc_vmem).  Streams are byte-identical to ``compress()`` per
    job.  ``pmap(fn, items)`` maps the per-job host work (default: a
    plain loop; the batch layer passes its thread pool).  Returns None
    when the replay refuses a job (the caller codes the batch with
    ``compress``); raises RuntimeError without the native host library,
    which holds the replay."""
    if not _use_native():
        raise RuntimeError(
            "fqz.compress_batch_device needs the native host library for "
            "its model replay (not built, or HTSCODECS_TORCH_NATIVE=0): "
            "use fqz.compress or engine=\"host\"")
    from ..ops import rc_vmem
    jobs = list(jobs)
    if not jobs:
        return []
    run = pmap if pmap is not None else (lambda fn, xs: [fn(x) for x in xs])
    parts = run(lambda job: _replay_job(job, vers), jobs)
    if any(p is None for p in parts):
        return None
    payloads = rc_vmem.enc_triples_batch([p[1] for p in parts], device=device)
    for _h, _t, caller_flags in parts:
        if caller_flags is not None:
            for r in range(len(caller_flags)):
                caller_flags[r] &= 0xFFFF
    return [p[0] + pay for p, pay in zip(parts, payloads)]


def decompress(buf, with_lengths: bool = False):
    """Decompress an fqz stream.  Returns bytes, or (bytes, lengths)
    when ``with_lengths``."""
    buf = memoryview(bytes(buf))
    end = len(buf)
    total, pos = varint.get_uint(buf, 0, end)
    gp, pos = read_parameters(buf, pos, end)
    if gp is None:
        raise ValueError("corrupt fqz stream")

    if _use_native():
        r = _native.fqz_dec_scan(bytes(buf[pos:end]), total, gp, _pack_gp(gp))
        if r is not None:
            out_arr, rec_lens, rec_revs, nrec = r
            lengths = [int(v) for v in rec_lens[:nrec]]
            if gp.gflags & GFLAG_DO_REV:
                i = 0
                for rv, ln in zip(rec_revs[:nrec], rec_lens[:nrec]):
                    ln = int(ln)
                    if rv:
                        out_arr[i:i + ln] = out_arr[i:i + ln][::-1]
                    i += ln
            data = out_arr.tobytes()
            return (data, lengths) if with_lengths else data
        raise ValueError("corrupt fqz stream")

    shifted = []
    for pm in gp.p:
        ptab = [v << pm.ploc for v in pm.ptab]
        dtab = [v << pm.dloc for v in pm.dtab]
        shifted.append((ptab, dtab))

    model = _Models(gp)
    rc = RangeDecoder(buf, pos, end)

    out = np.zeros(total, dtype=np.uint8)
    out_list = [0] * total
    state = {"qctx": 0, "p": 0, "delta": 0, "prevq": 0, "s": 0}
    first_len = 1
    rev_a = []
    len_a = []
    rev = 0
    last_len = 0
    last = 0
    lengths = []
    pm = gp.p[0]
    ptab, dtab = shifted[0]
    x = 0

    i = 0
    rec = 0
    ln = 0
    while i < total:
        if state["p"] == 0:
            if pm.do_sel:
                if model.sel is None:
                    raise ValueError("corrupt fqz stream (sel without stab)")
                state["s"] = model.sel.decode(rc)
            else:
                state["s"] = 0
            x = gp.stab[min(255, state["s"])] if (gp.gflags & GFLAG_HAVE_STAB) else state["s"]
            if x >= gp.nparam:
                raise ValueError("corrupt fqz stream (bad selector)")
            pm = gp.p[x]
            ptab, dtab = shifted[x]

            ln = last_len
            if not pm.fixed_len or first_len:
                ln = model.len[0].decode(rc)
                ln |= model.len[1].decode(rc) << 8
                ln |= model.len[2].decode(rc) << 16
                ln |= model.len[3].decode(rc) << 24
                first_len = 0
                last_len = ln
            if ln > total - i or ln <= 0:
                raise ValueError("corrupt fqz stream (bad length)")
            lengths.append(ln)

            if gp.gflags & GFLAG_DO_REV:
                rev = model.revcomp.decode(rc)
                rev_a.append(rev)
                len_a.append(ln)

            if pm.do_dedup:
                if model.dup.decode(rc):
                    if ln > i:
                        raise ValueError("corrupt fqz stream (bad dup)")
                    out_list[i:i + ln] = out_list[i - ln:i]
                    i += ln
                    state["p"] = 0
                    rec += 1
                    continue

            rec += 1
            state["p"] = ln
            state["delta"] = 0
            state["prevq"] = 0
            state["qctx"] = 0
            last = pm.context

        Q = model.qual(last).decode(rc)
        out_list[i] = pm.qmap[Q] & 0xFF
        state["qctx"] = (state["qctx"] << pm.qshift) + pm.qtab[Q]
        last = (((state["qctx"] & pm.qmask) << pm.qloc)
                + ptab[min(1023, state["p"])]
                + dtab[min(255, state["delta"])]
                + (state["s"] << pm.sloc)) & (CTX_SIZE - 1)
        if state["prevq"] != Q:
            state["delta"] += 1
        state["prevq"] = Q
        state["p"] -= 1
        i += 1

    out = np.array(out_list, dtype=np.uint8)

    if gp.gflags & GFLAG_DO_REV:
        i = 0
        r = 0
        while i < total and r < len(len_a):
            if rev_a[r]:
                out[i:i + len_a[r]] = out[i:i + len_a[r]][::-1]
            i += len_a[r]
            r += 1

    data = out.tobytes()
    if with_lengths:
        return data, lengths
    return data
