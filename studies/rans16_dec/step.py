#!/usr/bin/env python3
"""Timing study of the rANS 4x16 decoder's step on one GPU.

    python3 studies/rans16_dec/step.py [--seed S] [--out DIR]

On 16 quality-series blocks of 1 510 000 bytes (a CRAM 3.1 reader's 16
slices, the ``cram31-normal-qs`` configuration's generator), compressed
by ``batch.compress_blocks`` at order 1, it

- takes the tensors that ``batch.uncompress_blocks`` hands
  ``rans_vmem.rans16_dec`` (the host table parse's rows: shift and A
  are printed);
- times ``rans16_dec`` on its bisection route at 32, 64 and 128 threads
  a CTA and on its direct route (CUDA events, warm, median of 5), and
  gives each as ns a step of the 377 500-step chains; every output must
  equal the blocks, the default launch must take the direct route, and
  its first 1000 steps of every chain must equal the plain version's;
- holds the direct route's rule (``rans_vmem.direct_ctas_per_sm``: CTAs
  an SM from the shared memory, at most ``DIRECT_MAX_CTAS``) against
  the CUDA occupancy calculator (``rans16_dec_direct_ctas_per_sm``,
  capped the same) at every alphabet that fits, both orders, shifts 10
  and 12;
- sweeps B (the 16 blocks repeated) for both routes, the direct one
  launched past its rule too: order 1 at shift 10 (the cell's tables)
  and at shift 12 (tables of the same blocks at that precision), order
  0 at shift 12 (the batch layer's order-0 tables), and the rule's
  choice at each B;
- times both routes on short blocks (B = 16, N from 256 to 65 536,
  A = 8, shifts 10 and 12) and at the three descriptor groups of one
  Illumina tok3 block with the most bytes, where the direct route's
  prologue weighs most;
- writes the SASS of every kernel with ``rans16_dec`` in its name
  (``cuobjdump -sass`` of the kernel library) to DIR (default
  ``build/`` beside this file), with the compiler's register report.

It prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cram_bench.generators import qs_runs  # noqa: E402
from htscodecs_tpu_torch import cuda_build  # noqa: E402
from htscodecs_tpu_torch.models import batch  # noqa: E402
from htscodecs_tpu_torch.ops import convert, rans_vmem  # noqa: E402
from htscodecs_tpu_torch.utils import testdata  # noqa: E402

DEV = cs.DEV
B, N = 16, 1510000


def captured(blocks, order):
    """The (states, words, counts, tables) that uncompress_blocks hands
    rans16_dec for ``blocks`` compressed at ``order`` (one group)."""
    streams = batch.compress_blocks(list(blocks), order=order, device=DEV)
    seen = []
    orig = rans_vmem.rans16_dec

    def tap(st, wd, cn, tables, n, o, **kw):
        seen.append((st, wd, cn, tables))
        return orig(st, wd, cn, tables, n, o, **kw)
    rans_vmem.rans16_dec = tap
    try:
        outs = batch.uncompress_blocks(streams, device=DEV)
    finally:
        rans_vmem.rans16_dec = orig
    if len(seen) != 1 or outs != [b.tobytes() for b in blocks]:
        raise SystemExit(f"order {order}: {len(seen)} decoder launches, or "
                         "a block did not round-trip")
    return seen[0]


def direct(st, wd, cn, tables, n, order):
    """The direct route launched whatever the rule says (its rows
    packable)."""
    Bb, W = wd.shape
    A = tables.alpha.shape[1]
    out = torch.empty((Bb, n), dtype=torch.uint8, device=DEV)
    err = cuda_build.get_lib().rans16_dec_direct_launch(
        st.data_ptr(), wd.data_ptr(), cn.data_ptr(), tables.bases.data_ptr(),
        tables.alpha.data_ptr(), tables.shift.data_ptr(), out.data_ptr(),
        Bb, W, A, n, order, int(tables.shift.max()),
        torch.cuda.current_stream(DEV).cuda_stream)
    cuda_build.check(err, "rans16_dec_direct")
    return out


def routes(bt, st, wd, cn, tables, order):
    A = tables.alpha.shape[1]
    K = rans_vmem._dec_geometry(N, order)[1]
    res = {"A": A, "order": order,
           "shift": sorted(set(tables.shift.cpu().tolist())),
           "words": int(cn.sum())}
    for t in (32, 64, 128):
        out = rans_vmem.rans16_dec(st, wd, cn, tables, N, order, threads=t)
        if not torch.equal(out, bt):
            raise SystemExit(f"bisection route at {t} threads: wrong output")
        ms = cs.cuda_ms(lambda: rans_vmem.rans16_dec(st, wd, cn, tables, N,
                                                     order, threads=t))
        res[f"bisection threads{t}"] = {"ms": ms, "ns_step": ms * 1e6 / K}
    rans_vmem.reset_launches()
    out = rans_vmem.rans16_dec(st, wd, cn, tables, N, order)
    if rans_vmem.LAUNCHES["rans16_dec_direct"] != 1:
        raise SystemExit(f"the default launch did not take the direct route: "
                         f"{rans_vmem.LAUNCHES}")
    if not torch.equal(out, bt):
        raise SystemExit("direct route: wrong output")
    ms = cs.cuda_ms(lambda: rans_vmem.rans16_dec(st, wd, cn, tables, N,
                                                 order))
    res["direct"] = {"ms": ms, "ns_step": ms * 1e6 / K,
                     "host_check_ms": host_check_ms(tables, order)}
    if order == 1:
        q = N >> 2
        head = rans_vmem._rans16_dec_plain(st, wd, cn, tables, 4000, 1)
        for lane in range(4):
            if not torch.equal(head[:, lane * 1000:(lane + 1) * 1000],
                               out[:, lane * q:lane * q + 1000]):
                raise SystemExit(f"direct route != plain on the first 1000 "
                                 f"steps of state {lane}")
        res["plain_first_1000_steps"] = "equal"
    return res


def occupancy():
    lib = cuda_build.get_lib()
    lim = rans_vmem._device_limits(DEV)
    out, bad = {}, []
    for order, shift, As in ((1, 10, range(1, 57)), (1, 12, range(1, 16)),
                             (0, 10, (1, 2, 8, 64, 128)),
                             (0, 12, (1, 2, 8, 64, 128))):
        for A in As:
            rule = rans_vmem.direct_ctas_per_sm(A, order, shift, *lim[1:])
            cuda = min(max(lib.rans16_dec_direct_ctas_per_sm(
                A, order, shift), 0), rans_vmem.DIRECT_MAX_CTAS)
            out[f"order{order} shift{shift} A={A}"] = [rule, cuda]
            if rule != cuda:
                bad.append((order, shift, A, rule, cuda))
    return {"limits": lim, "ctas_per_sm [rule, cuda]": out, "differ": bad}


def sweep(bt, st, wd, cn, tables, order, Bs):
    """ms a launch of each route at each B of ``Bs`` (the 16 blocks
    repeated), and the rule's choice."""
    A = tables.alpha.shape[1]
    shift = int(tables.shift.max())
    lim = rans_vmem._device_limits(DEV)
    res = {"shape": f"A={A} N={N} order={order} shift={shift}",
           "ctas_per_sm": rans_vmem.direct_ctas_per_sm(A, order, shift,
                                                       *lim[1:])}
    for Bb in Bs:
        ix = torch.arange(Bb, device=DEV) % B
        tb = convert.Tables(*(t[ix].contiguous() for t in tables))
        args = (st[ix].contiguous(), wd[ix].contiguous(), cn[ix].contiguous(),
                tb, N, order)
        want = bt[ix]
        if not (torch.equal(direct(*args), want) and torch.equal(
                rans_vmem.rans16_dec(*args, threads=32), want)):
            raise SystemExit(f"sweep: a route did not decode B={Bb}")
        del want
        res[f"B={Bb}"] = {
            "rule": cs.dec16_key(tb, order),
            "direct_ms": cs.cuda_ms(lambda: direct(*args), reps=3),
            "bisection_ms": cs.cuda_ms(lambda: rans_vmem.rans16_dec(
                *args, threads=32), reps=3)}
        print(f"  {res['shape']} B={Bb} {res[f'B={Bb}']}", flush=True)
        del args, tb
    return res


def short_blocks(qs):
    """Both routes at B = 16 on the first n bytes of each block, A = 8,
    shifts 10 and 12: where the prologue (the fill of A << shift words)
    weighs against a short chain."""
    res = {}
    for shift in (10, 12):
        for n in (256, 1024, 2500, 10000, 65536):
            st, wd, cn, tables = cs.case16(qs[:, :n], np.int32(shift), 1, 8)
            want = torch.from_numpy(np.ascontiguousarray(qs[:, :n])).to(DEV)
            d = rans_vmem.rans16_dec(st, wd, cn, tables, n, 1)
            if not torch.equal(d, want):
                raise SystemExit(f"short blocks n={n}: wrong output")
            res[f"shift{shift} N={n}"] = {
                "rule": cs.dec16_key(tables, 1),
                "direct_ms": cs.cuda_ms(lambda: direct(st, wd, cn, tables, n,
                                                       1)),
                "bisection_ms": cs.cuda_ms(lambda: rans_vmem.rans16_dec(
                    st, wd, cn, tables, n, 1, threads=32))}
    return res


def host_check_ms(tables, order, reps=5):
    """Host wall ms of the wrapper's route choice (``_direct_shift``: the
    rule, and for a launch it admits the copies of the shifts and rows
    and the row check), the stream idle before it; median of ``reps``."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rans_vmem._direct_shift(tables, order, 0, False)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def tok3_groups():
    """Both routes at the three descriptor groups of one Illumina block
    (10 000 names) with the most bytes, on the device-table route's
    tables: the default launch (the route choice on the host included),
    the direct route's kernel alone, the bisection route, and the host
    check alone."""
    groups, _nj, _ng = cs.descriptor_groups(
        testdata.synth_names(10000, "illumina", seed=0))
    res = {}
    for arr, o in groups[:3]:
        Bb, n = arr.shape
        alpha, packed, shift, A = cs.device_tables(arr, o)
        bt = torch.from_numpy(arr).to(DEV)
        st, wd, cn = rans_vmem.rans16_enc_packed(bt, alpha, packed, shift, o)
        wd = convert.words_forward(wd, cn).contiguous()
        tables = convert.tables_from_packed(
            alpha, packed.view((Bb, A, A) if o else (Bb, A)), shift)
        if not torch.equal(rans_vmem.rans16_dec(st, wd, cn, tables, n, o), bt):
            raise SystemExit(f"tok3 group {arr.shape}: wrong output")
        res[f"B={Bb} N={n} A={A} order={o} shift="
            f"{sorted(set(shift.cpu().tolist()))}"] = {
            "rule": cs.dec16_key(tables, o),
            "default_ms": cs.cuda_ms(lambda: rans_vmem.rans16_dec(
                st, wd, cn, tables, n, o)),
            "direct_kernel_ms": cs.cuda_ms(lambda: direct(st, wd, cn, tables,
                                                          n, o)),
            "bisection_ms": cs.cuda_ms(lambda: rans_vmem.rans16_dec(
                st, wd, cn, tables, n, o, threads=32)),
            "host_check_ms": host_check_ms(tables, o)}
    return res


def sass(out_dir: Path):
    so = sorted(cuda_build.BUILD_DIR.glob("libhtscuda_*.so"))[-1]
    cuobjdump = Path(cuda_build._nvcc()).resolve().parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    counts, keep, cur = {}, [], None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            cur = cur if "rans16_dec" in cur else None
            if cur:
                counts[cur] = 0
        if cur:
            keep.append(line)
            if line.strip().startswith("/*") and "*/" in line[:20]:
                counts[cur] += 1
    (out_dir / "rans16_dec_sass.txt").write_text("\n".join(keep) + "\n")
    (out_dir / "rans16_dec_ptxas.txt").write_text(cuda_build.build_log)
    return {"instructions": counts, "so": so.name}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2147485003)
    ap.add_argument("--out", default=str(HERE / "build"))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    cuda_build.get_lib()
    cfg = json.loads((ROOT / "cram_bench/configs/cram31-normal-qs.json")
                     .read_text())
    blocks = np.stack(qs_runs.blocks(cfg, args.seed, range(B), 8))
    bt = torch.from_numpy(blocks).to(DEV)
    rep = {"card": smi, "shape": f"B={B} N={N}", "occupancy": occupancy()}
    print(json.dumps(rep["occupancy"]), flush=True)
    o1 = captured(blocks, 1)
    rep["cell order 1"] = routes(bt, *o1, 1)
    print("cell order 1", json.dumps(rep["cell order 1"]), flush=True)
    o0 = captured(blocks, 0)
    rep["cell order 0"] = routes(bt, *o0, 0)
    print("cell order 0", json.dumps(rep["cell order 0"]), flush=True)
    rep["sweep order 1"] = sweep(bt, *o1, 1, (16, 132, 133, 264, 528, 529,
                                              792, 793, 1056))
    del o1
    rep["sweep order 0"] = sweep(bt, *o0, 0, (16, 528, 529, 1584, 1585,
                                              2112, 2113))
    del o0
    o12 = cs.case16(blocks, np.int32(12), 1, 8)
    if not torch.equal(rans_vmem.rans16_dec(*o12, N, 1), bt):
        raise SystemExit("shift-12 tables: wrong output")
    rep["sweep order 1 shift 12"] = sweep(bt, *o12, 1, (16, 132, 133, 264,
                                                        396, 528, 529))
    del o12
    rep["short blocks"] = short_blocks(blocks[:, :65536].copy())
    print("short blocks", json.dumps(rep["short blocks"]), flush=True)
    rep["tok3 groups"] = tok3_groups()
    print("tok3 groups", json.dumps(rep["tok3 groups"]), flush=True)
    rep["sass"] = sass(Path(args.out).resolve())
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
