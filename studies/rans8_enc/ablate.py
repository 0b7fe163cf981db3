#!/usr/bin/env python3
"""Timing study of the rANS 4x8 encoder kernel on one GPU.

    python3 studies/rans8_enc/ablate.py --parent DIR

DIR is a checkout of the commit before the redesign of ``rans8_enc``
(d0730d3, for example unpacked with ``git archive``).  The study keeps no
copy of a kernel: every source it builds is made by text substitution
from a checked-in kernel, and it stops if a text to replace is missing.
On the tables and blocks of the 4x8 main path of ``chip_smoke.py``
(synth4 order 1 and 0, B = 4096 x 64 KiB; wide41 order 1, B = 1024) it

- splits the old kernel's step (DIR's ``csrc/rans8_enc.cu``, built
  against DIR's headers, with ``clock64()`` stamps put in) into its
  lookup, its emission and its divide, in cycles per step of state 3's
  lane, mean over blocks, and checks that the stamped copy gives DIR's
  states;
- times this checkout's ``rans8_enc`` against step 1 of the redesign
  (this checkout's kernel with step 1's order-1 key) and against
  variants of step 1, in turns (median of 3 medians of 5 CUDA-event
  timings): without the byte stores and with one ballot (both give wrong
  output: timing only), with the 4x16 encoder's key rule (another answer
  for bytes past the alphabet), and with the order-1 key tests joined by
  ``&`` in two forms.  Each variant that must give the kernel's output
  is checked against it.

It prints one JSON object as its last line.  Builds go to ``build/``
beside this file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from htscodecs_tpu_torch import cuda_build  # noqa: E402
from htscodecs_tpu_torch.ops import rans8_vmem, rans_vmem  # noqa: E402
from htscodecs_tpu_torch.utils import testdata  # noqa: E402

# the kernel's key (step 2) -> step 1's
STEP1 = [('''        int key;
        if (ORDER) {
            const uint32_t ctx = pos(t) != lo ? d1 : 0u;
            const int k = min((int)(d0 + ctx * A), A2);
            key = coded(t) & (d0 < (uint32_t)A) ? k : A2;
        } else {
            key = coded(t) && d0 < (uint32_t)A ? (int)d0 : A2;
        }''', '''        const uint32_t ctx = ORDER && pos(t) != lo ? d1 : 0u;
        const int key = coded(t) && max(d0, ctx) < (uint32_t)A
                            ? (int)(d0 + ctx * A) : A2;''')]
KEY = STEP1[0][1][STEP1[0][1].index("        const int key"):]
# name -> (substitutions into step 1, whether the output must equal the
# kernel's on the main path's data)
VARIANTS = {
    "step1": ([], True),
    "step1 without the byte stores": ([
        ("        st_if(emit1 && live, w - r, X);\n", "        (void)r;\n"),
        ("        st_if(emit2 && live, w - r - 1, x1);\n", "")], False),
    "step1 with one ballot": ([(
        "        const unsigned g2 = (__ballot_sync(0xffffffffu, emit2) >> gsh) & 0xFu;",
        "        const unsigned g2 = 0u;")], False),
    "step1 with the 4x16 key rule": ([(KEY, '''        const int key = coded(t) ? min((int)(d0 + ctx * A), A2) : A2;''')],
                                     True),
    "step1 with & for &&": ([(KEY, '''        const int key = coded(t) & (max(d0, ctx) < (uint32_t)A)
                            ? (int)(d0 + ctx * A) : A2;''')], True),
    "step1 with min and &": ([(KEY, '''        const int k0 = min((int)(d0 + ctx * A), A2);
        const int key = coded(t) & (ORDER == 0 || d0 < (uint32_t)A) ? k0 : A2;''')],
                             True),
}
# the old kernel (DIR's csrc/rans8_enc.cu) -> its copy with clock64()
# stamps around the lookup, the emission (two ballots, byte stores under
# a branch) and the divide with the update, in prof (B, 4 lanes, 3)
CLOCK = [
    ("                 int32_t* __restrict__ counts,\n",
     "                 int32_t* __restrict__ counts,\n"
     "                 long long* __restrict__ prof,\n"),
    ("    for (int s = 0; s < K; ++s) {\n",
     "    long long c0 = 0, c1 = 0, c2 = 0;\n"
     "    for (int s = 0; s < K; ++s) {\n"
     "        const long long t0 = clock64();\n"),
    ("        const uint32_t x_max = XMULT * f;\n",
     "        const uint32_t x_max = XMULT * f;\n"
     "        asm volatile(\"\" :: \"r\"(x_max), \"r\"(start));\n"
     "        const long long t1 = clock64();\n"),
    ("        n += __popc(g1) + __popc(g2);\n",
     "        n += __popc(g1) + __popc(g2);\n"
     "        asm volatile(\"\" :: \"r\"(n), \"r\"(x2));\n"
     "        const long long t2 = clock64();\n"),
    ("            X = (qq << SHIFT) + (x2 - qq * fs) + start;\n        }\n",
     "            X = (qq << SHIFT) + (x2 - qq * fs) + start;\n        }\n"
     "        asm volatile(\"\" :: \"r\"(X));\n"
     "        const long long t3 = clock64();\n"
     "        c0 += t1 - t0; c1 += t2 - t1; c2 += t3 - t2;\n"),
    ("        if (j == 0) counts[bb] = n;\n",
     "        if (j == 0) counts[bb] = n;\n"
     "        prof[bb * 12 + j * 3 + 0] = c0;\n"
     "        prof[bb * 12 + j * 3 + 1] = c1;\n"
     "        prof[bb * 12 + j * 3 + 2] = c2;\n"),
    ("                                void* counts, int B,",
     "                                void* counts, void* prof, int B,"),
    ("            (uint32_t*)states, (uint8_t*)out, (int32_t*)counts,\n",
     "            (uint32_t*)states, (uint8_t*)out, (int32_t*)counts,\n"
     "            (long long*)prof,\n"),
]


def substituted(text: str, subs, name: str) -> str:
    for old, new in subs:
        if text.count(old) < 1:
            raise SystemExit(f"ablate: {name}: text to replace not found:\n"
                             f"{old}")
        text = text.replace(old, new)
    return text


def nvcc_so(src: Path, so: Path, include: Path):
    """Compile one source into a shared library; returns the process."""
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
         f"-I{include}", str(src), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent: Path):
    """The variants' libraries and the old kernel's clock library, all
    compiled at once."""
    out = HERE / "build"
    out.mkdir(exist_ok=True)
    csrc = ROOT / "htscodecs_tpu_torch" / "csrc"
    step1 = substituted((csrc / "rans8_enc.cu").read_text(), STEP1, "step1")
    srcs = {name: (substituted(step1, subs, name), csrc)
            for name, (subs, _same) in VARIANTS.items()}
    pcsrc = parent / "htscodecs_tpu_torch" / "csrc"
    srcs["clock"] = (substituted((pcsrc / "rans8_enc.cu").read_text(), CLOCK,
                                 "clock"), pcsrc)
    procs = {}
    for i, (name, (text, inc)) in enumerate(srcs.items()):
        src = out / f"variant{i}.cu"
        src.write_text(text)
        procs[name] = (nvcc_so(src, out / f"variant{i}.so", inc),
                       out / f"variant{i}.so")
    libs = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"ablate: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(so)).rans8_enc_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       if name == "clock" else
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6) \
            + [ctypes.c_void_p]
        libs[name] = fn
    return libs


def clock_split(clk, par, blocks, alpha, packed, order):
    """Cycles per step of the old kernel's three parts (state 3's lane),
    and whether its stamped copy gives the old kernel's states."""
    par_r8, par_vmem, par_convert = par
    B = blocks.shape[0]
    A = alpha.shape[1]
    bt = torch.from_numpy(blocks).to(cs.DEV)
    tables = par_convert.tables8_from_reference(alpha, packed, cs.DEV)
    sym, ctx, K, geom = par_vmem.enc_inputs(bt, tables, order)
    st = torch.empty((B, 4), dtype=torch.int32, device=cs.DEV)
    out = torch.empty((B, 8 * K), dtype=torch.uint8, device=cs.DEV)
    cn = torch.empty((B,), dtype=torch.int32, device=cs.DEV)
    prof = torch.zeros((B, 12), dtype=torch.int64, device=cs.DEV)
    err = clk(sym.data_ptr(), ctx.data_ptr(), tables.bases.data_ptr(),
              st.data_ptr(), out.data_ptr(), cn.data_ptr(), prof.data_ptr(),
              B, K, A, geom, 8 * K, order,
              torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise SystemExit(f"ablate: the clock kernel failed with {err}")
    ref = par_r8.rans8_enc(sym, ctx, tables, K, geom, order)
    parts = (prof.view(B, 4, 3)[:, 0].double().mean(dim=0) / K).tolist()
    return {"lookup": parts[0], "emit": parts[1], "divide": parts[2],
            "whole": sum(parts),
            "same_states": bool(torch.equal(ref[0], st))}


def time_variants(libs, blocks, alpha, packed, order):
    B, N = blocks.shape
    A = alpha.shape[1]
    bt = torch.from_numpy(blocks).to(cs.DEV)
    al = torch.from_numpy(alpha).to(cs.DEV)
    pk = cs.r8_packed(packed)
    K = rans_vmem._enc_geometry(N, order)[0]
    smem = int(rans_vmem.enc_tables_in_smem(A, order))
    st = torch.empty((B, 4), dtype=torch.int32, device=cs.DEV)
    out = torch.empty((B, 8 * K), dtype=torch.uint8, device=cs.DEV)
    cn = torch.empty((B,), dtype=torch.int32, device=cs.DEV)

    def launcher(fn):
        def run():
            err = fn(bt.data_ptr(), al.data_ptr(), pk.data_ptr(),
                     st.data_ptr(), out.data_ptr(), cn.data_ptr(), B, N, A,
                     order, 8 * K, smem,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ablate: a variant failed with {err}")
        return run

    ref = rans8_vmem.rans8_enc(bt, al, pk, order)
    runs = {"kernel": lambda: rans8_vmem.rans8_enc(bt, al, pk, order)}
    for name, (_subs, same) in VARIANTS.items():
        runs[name] = launcher(libs[name])
        if same:
            runs[name]()
            torch.cuda.synchronize()
            if not (torch.equal(st, ref[0]) and torch.equal(cn, ref[2])
                    and cs.same_suffix(out, ref[1], cn)):
                raise SystemExit(f"ablate: {name} differs from the kernel")
    ts = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            ts[k].append(cs.cuda_ms(fn))
    return {k: statistics.median(v) for k, v in ts.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout from before the redesign")
    args = ap.parse_args()
    parent = Path(args.parent).resolve()
    cuda_build.get_lib()
    libs = build(parent)
    mods = cs.load_parent(parent)
    par = (mods[2], mods[3], mods[5])
    q4 = testdata.synth_quality(4096, 65536, seed=42)
    wide = testdata.synth_wide(1024, 65536, 40, seed=9)
    res = {}
    for name, blocks, order in (("synth4 order 1", q4, 1),
                                ("synth4 order 0", q4, 0),
                                ("wide41 order 1", wide, 1)):
        alpha, packed = cs.rans8_tables(blocks, order)
        res[name] = {
            "old kernel cycles per step": clock_split(
                libs["clock"], par, blocks, alpha, packed, order),
            "ms": time_variants(libs, blocks, alpha, packed, order)}
        print(name, json.dumps(res[name]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    print(json.dumps({"rans8_enc_study": res, "card": smi.strip()}),
          flush=True)


if __name__ == "__main__":
    main()
