#!/usr/bin/env python3
"""Timing study of the rANS 4x8 decoder's step on one GPU.

    python3 studies/rans8_dec/step.py [--seed S] [--out DIR]

On 16 quality-series blocks of 1 510 000 bytes (a CRAM 3.0 reader's 16
slices, the ``cram30-qs`` configuration's generator), written by the
port's 4x8 encoder, it

- times ``rans8_vmem.rans8_dec`` on its bisection route at 32, 64 and
  128 threads a CTA and on its direct route (CUDA events, warm, median
  of 5), at the batch layer's alphabet bucket (A = 8, the tables of
  ``batch._r8_parse_group``) and at the blocks' own alphabet (A = 5),
  and gives each as ns a step of the 377 500-step chains; every output
  must equal the blocks;
- holds the direct route's rule (``rans8_vmem.direct_ctas_per_sm``: CTAs
  an SM from the shared memory alone) against the CUDA occupancy calculator
  (``rans8_dec_direct_ctas_per_sm``) at every alphabet that fits, both
  orders;
- times the plain version for 1000 steps at the same shape;
- writes the SASS of every kernel with ``rans8_dec`` in its name
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

from cram_bench.generators import qs_runs  # noqa: E402
from htscodecs_tpu_torch import cuda_build, native  # noqa: E402
from htscodecs_tpu_torch.models import batch  # noqa: E402
from htscodecs_tpu_torch.ops import convert, rans8_vmem, rans_vmem  # noqa: E402

DEV = torch.device("cuda", 0)
B, N = 16, 1510000


def cuda_ms(fn, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def inputs(blocks, exact_alphabet):
    """(states, stream, counts, tables) of the 16 blocks: the batch
    layer's streams and parsed tables (A = its bucket), or streams
    written with each block's own alphabet (A = distinct bytes + byte 0,
    the encoder's rows padded to the widest)."""
    if not exact_alphabet:
        streams = batch.r4x8_compress_blocks(list(blocks), order=1,
                                             engine="device", device=DEV)
        states, stream, nbs, alpha, packed = batch._r8_parse_group(
            list(enumerate(streams)), 1)
        st, by, cn = convert.streams8_from_reference(states, stream, DEV, nbs)
        return st, by, cn, convert.tables8_from_reference(alpha, packed, DEV)
    res = [native.r8_build_tables_dense(b, 1) for b in blocks]
    A = max(len(r[1]) for r in res)
    alpha = np.zeros((len(res), A), np.uint8)
    packed = np.zeros((len(res), A, A), np.int32)
    for k, (_t, al, pk) in enumerate(res):
        a = len(al)
        alpha[k, :a], alpha[k, a:] = al, al[-1]
        packed[k, :a, :a] = pk
    bt = torch.from_numpy(np.ascontiguousarray(blocks)).to(DEV)
    st, by, cn = rans8_vmem.enc_batch(bt, alpha, packed, 1)
    return (st, convert.words_forward(by, cn).contiguous(), cn,
            convert.tables8_from_reference(alpha, packed, DEV))


def routes(blocks, bt, exact_alphabet):
    st, stream, cn, tables = inputs(blocks, exact_alphabet)
    A = tables.alpha.shape[1]
    K = rans8_vmem._dec_geometry(N, 1)[1]
    res = {"A": A, "stream_bytes": int(cn.sum())}
    for t in (32, 64, 128):
        out = rans8_vmem.rans8_dec(st, stream, cn, tables, N, 1, threads=t)
        if not torch.equal(out, bt):
            raise SystemExit(f"bisection route at {t} threads: wrong output")
        ms = cuda_ms(lambda: rans8_vmem.rans8_dec(st, stream, cn, tables, N,
                                                  1, threads=t))
        res[f"bisection threads{t}"] = {"ms": ms, "ns_step": ms * 1e6 / K}
    rans_vmem.reset_launches()
    out = rans8_vmem.rans8_dec(st, stream, cn, tables, N, 1)
    if rans_vmem.LAUNCHES["rans8_dec_direct"] != 1:
        raise SystemExit(f"the default launch did not take the direct route: "
                         f"{rans_vmem.LAUNCHES}")
    if not torch.equal(out, bt):
        raise SystemExit("direct route: wrong output")
    ms = cuda_ms(lambda: rans8_vmem.rans8_dec(st, stream, cn, tables, N, 1))
    res["direct"] = {"ms": ms, "ns_step": ms * 1e6 / K}
    if exact_alphabet:
        t0 = time.perf_counter()
        rans8_vmem._rans8_dec_plain(st, stream, cn, tables, 4000, 1)
        torch.cuda.synchronize()
        res["plain_ms_a_step"] = (time.perf_counter() - t0)     # 1000 steps
        res["plain_s_at_the_shape"] = res["plain_ms_a_step"] * K / 1e3
    return res


def occupancy():
    lib = cuda_build.get_lib()
    lim = rans8_vmem._device_limits(DEV)
    out, bad = {}, []
    for order, As in ((1, range(1, 15)), (0, (1, 2, 5, 8, 64, 128))):
        for A in As:
            rule = rans8_vmem.direct_ctas_per_sm(A, order, *lim[1:])
            cuda = lib.rans8_dec_direct_ctas_per_sm(A, order)
            out[f"order{order} A={A}"] = [rule, cuda]
            if rule != cuda:
                bad.append((order, A, rule, cuda))
    return {"limits": lim, "ctas_per_sm [rule, cuda]": out, "differ": bad}


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
            cur = cur if "rans8_dec" in cur else None
            if cur:
                counts[cur] = 0
        if cur:
            keep.append(line)
            if line.strip().startswith("/*") and "*/" in line[:20]:
                counts[cur] += 1
    (out_dir / "rans8_dec_sass.txt").write_text("\n".join(keep) + "\n")
    (out_dir / "rans8_dec_ptxas.txt").write_text(cuda_build.build_log)
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
    cfg = json.loads((ROOT / "cram_bench/configs/cram30-qs.json").read_text())
    blocks = np.stack(qs_runs.blocks(cfg, args.seed, range(B), 8))
    bt = torch.from_numpy(blocks).to(DEV)
    rep = {"card": smi, "shape": f"B={B} N={N} order=1",
           "occupancy": occupancy()}
    print(json.dumps(rep["occupancy"]), flush=True)
    for tag, exact in (("bucket", False), ("own alphabet", True)):
        rep[tag] = routes(blocks, bt, exact)
        print(tag, json.dumps(rep[tag]), flush=True)
    rep["sass"] = sass(Path(args.out).resolve())
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
