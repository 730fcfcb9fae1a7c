#!/usr/bin/env python3
"""Registers, resident blocks and SASS of every variant of the fused-window
kernel (K1) for the port's package found under ``--root``.

    python3 scripts/kernel_resources.py [--root DIR] [--out DIR] [--philox]

For each model body and variant (in-kernel normals, ESS gate, valid gate)
the script prints what the CUDA runtime reports through the package's
library (``ops/cuda/fused_pf.py``'s ``fused_window_occupancy``:
``cudaFuncGetAttributes`` and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
at N=1024): registers, local memory, shared memory per block, resident
blocks per SM and which of threads, registers or shared memory sets them.

Then it compiles each body's translation unit (``csrc/fused_window_<body>.cu``)
to a cubin with the flags of ``ops/cuda/build.py`` plus ``-lineinfo``,
disassembles it (``nvdisasm -gi``) and counts each variant's SASS
instructions by the source line each comes from: the model body
(``*_body.cuh``), the Philox generator (``philox.cuh``), and the regions of
``fused_window.cuh`` that ``// @region NAME`` comments open.  Instructions
from CUDA's math headers count to the innermost call site in ``csrc/``.
``BAR.SYNC`` instructions are counted per region as well.  The counts are
static: an instruction in a loop counts once.

Writes ``resources.json`` and the disassembly (gzipped) into ``--out``, and
prints one line per variant.  ``--philox`` counts the SASS of the
standalone Philox kernels (``csrc/philox_normals.cu``) by opcode instead.
Needs a CUDA device and the CUDA toolkit.
"""
import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N = 1024


def tool(name):
    found = shutil.which(name)
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if path.exists():
        return str(path)
    raise SystemExit(f"kernel_resources: {name} not found")


def regions_of(header):
    """[(lo, hi, name)] line ranges of fused_window.cuh."""
    marks = [(i + 1, m.group(1)) for i, ln in
             enumerate(header.read_text().splitlines())
             if (m := re.search(r"//\s*@region\s+(\S+)", ln))]
    return [(lo, (marks[k + 1][0] - 1 if k + 1 < len(marks) else 10 ** 9),
             name) for k, (lo, name) in enumerate(marks)]


def classify(locs, csrc, regions):
    """The region of an instruction from its line-info chain (innermost
    first): the first location inside csrc/ decides."""
    for f, line in locs:
        p = Path(f).name
        if not (Path(f).parent.name == "csrc" or (csrc / p).exists()):
            continue
        if p.endswith("_body.cuh"):
            return "body"
        if p == "philox.cuh":
            return "rng"
        if p == "fused_window.cuh":
            for lo, hi, name in regions:
                if lo <= line <= hi:
                    return name
            return "other"
        return p
    return "unattributed"


def parse_sass(text, csrc, regions):
    """{mangled function: (Counter of instructions, Counter of barriers)}."""
    funcs, cur, locs, in_chain = {}, None, [], False
    for ln in text.splitlines():
        m = re.match(r"^\s*\.text\.(\S+):", ln)
        if m:
            cur = m.group(1)
            funcs[cur] = (Counter(), Counter())
            locs = []
            continue
        if "//##" in ln:
            # an inlined instruction has one comment line per frame,
            # innermost first: the first of a run starts a new chain
            if not in_chain:
                locs = []
            in_chain = True
            locs += [(f, int(n)) for f, n in
                     re.findall(r'"([^"]+)",\s*line\s+(\d+)', ln)]
            continue
        in_chain = False
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", ln)
        if m and cur is not None:
            op = m.group(1)
            region = classify(locs, csrc, regions)
            funcs[cur][0][region] += 1
            if re.search(r"\bBAR\.SYNC|\bBAR\b", op) and "BAR.ARV" not in op:
                funcs[cur][1][region] += 1
    return funcs


def variant_of(mangled):
    """(body struct, in-kernel normals, ESS gate, valid gate) of a K1
    kernel's mangled name, or None for another function."""
    m = re.search(r"fused_window_kernelI\d+(\w+?)Lb([01])ELb([01])ELb([01])E",
                  mangled)
    if not m:
        return None
    return (m.group(1),) + tuple(g == "1" for g in m.groups()[1:])


def philox_sass(csrc, out, nvcc_flags):
    """Static SASS of the Philox kernels by opcode (one thread's work: the
    kernel has no loop), with the integer multiplies and the special-
    function (MUFU) instructions apart."""
    cubin = out / "philox_normals.cubin"
    subprocess.run([tool("nvcc"), *nvcc_flags, "-cubin", "-o", str(cubin),
                    str(csrc / "philox_normals.cu")], check=True,
                   capture_output=True)
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    cur = None
    ops = {}
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            ops[cur] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      ln)
        if m and cur is not None:
            ops[cur][m.group(1).split(".")[0]] += 1
    for name, c in ops.items():
        total = sum(c.values())
        imul = sum(v for k, v in c.items() if k.startswith("IMAD"))
        print(f"{name}: {total} SASS instructions, {imul} IMAD*, "
              f"{c.get('MUFU', 0)} MUFU, {c.get('NOP', 0)} NOP; "
              f"{dict(c.most_common(14))}", flush=True)
    cubin.unlink()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="build/kernel_resources")
    ap.add_argument("--philox", action="store_true",
                    help="count the SASS of the standalone Philox kernels "
                         "by opcode instead")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from sgmcmc_tpu_torch.ops.cuda import build, fused_pf
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_resources: no CUDA device is available")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    csrc = root / "sgmcmc_tpu_torch" / "csrc"
    if args.philox:
        philox_sass(csrc, out, build.NVCC_FLAGS)
        return
    regions = regions_of(csrc / "fused_window.cuh")
    flags = list(build.NVCC_FLAGS) + ["-lineinfo"]
    bodies = []
    for src in sorted(csrc.glob("fused_window_*.cu")):
        m = re.search(r"SGMCMC_FUSED_WINDOW_ENTRY\((\w+),\s*(\w+)\)",
                      src.read_text())
        bodies.append((m.group(1), src))

    def disassemble(item):
        name, src = item
        cubin = out / f"{name}.cubin"
        subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True)
        sass = subprocess.run([tool("nvdisasm"), "-c", "-gi", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
        cubin.unlink()
        return name, sass

    with ThreadPoolExecutor(len(bodies)) as ex:
        built = list(ex.map(disassemble, bodies))
    records = []
    for name, sass in built:
        with gzip.open(out / f"sass_{name}.txt.gz", "wt") as f:
            f.write(sass)
        sass_of = {}
        for mangled, (ins, bars) in parse_sass(sass, csrc, regions).items():
            var = variant_of(mangled)
            if var is not None:
                sass_of[var[1:]] = (ins, bars)
        for rng in (False, True):
            for gate in (False, True):
                for valid in (False, True):
                    occ = fused_pf.fused_window_occupancy(name, rng, gate,
                                                          valid, N)
                    ins, bars = sass_of[(rng, gate, valid)]
                    r = dict(body=name, rng=rng, ess_gate=gate,
                             valid_gate=valid, N=N, **occ,
                             sass_total=sum(ins.values()),
                             sass_by_region=dict(ins), barriers=dict(bars))
                    records.append(r)
                    print(f"{name} rng={int(rng)} gate={int(gate)} "
                          f"valid={int(valid)}: regs {r['registers']}, "
                          f"local {r['local_bytes']} B, "
                          f"{r['blocks_per_sm']} blocks/SM, smem "
                          f"{r['smem_bytes']} B, set by {r['set_by']}; "
                          f"SASS {r['sass_total']} {r['sass_by_region']}; "
                          f"BAR {r['barriers']}", flush=True)
    (out / "resources.json").write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
