"""Instructions of the back-projector's staged gather loop, per voxel pair.

    PYTHONPATH=src python3 tools/bp_sass_count.py [--source CU]
    python3 tools/bp_sass_count.py --sass LISTING [--log PTXAS_LOG]

Builds the back-projection library (`kernels/backproject/csrc/backproject.cu`,
or another revision of it given by `--source`) with the port's nvcc flags,
disassembles it with `cuobjdump -sass` and, for each `bp_dual_kernel`
instance, finds the staged gather: the basic block (cut at branches and
at branch targets) with the most shared-memory tap loads (`LDS` that is
not a 64- or 128-bit table read) and no global load, copy or shared
store -- the unrolled gathers of one (warp, projection) step. Its
instructions are counted by class and divided by the mirrored voxel pairs
it gathers a thread, (TI TJ / warps) x (TK / 32), the tile read from the
instance's template arguments and the warps from the source's `kWarps`.
The step's synchronisation (a block-wide `BAR`, or the ring's `SYNCS`
mbarrier waits and arrivals) lies outside the block and is not counted.
Prints one row per instance, with the registers and spill bytes of nvcc's
`-Xptxas -v` report. Needs nvcc and cuobjdump (the
card's machine), unless `--sass` reads a saved `cuobjdump -sass` listing
(and `--log` the build's ptxas report, the library's `.log` beside it);
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "backproject" / "csrc" \
    / "backproject.cu"

# Opcode (before the first dot) -> class.
CLASSES = {
    "lds": ("LDS",),
    "conversion": ("F2I", "I2F", "FRND", "F2F", "F2FP", "I2FP", "I2I",
                   "F2IP"),
    "fp32": ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FSET",
             "FCHK", "FSWZADD"),
    "fp16": ("HADD2", "HMUL2", "HFMA2", "HSETP2", "HMNMX2"),
    "integer": ("IADD3", "IADD", "IMAD", "LEA", "LOP3", "LOP", "ISETP",
                "IMNMX", "VIMNMX", "SHF", "SEL", "PRMT", "IABS", "POPC",
                "FLO", "BMSK", "SGXT", "IDP", "IMUL", "PLOP3", "P2R", "R2P",
                "VIADD", "VIADDMNMX", "VIMNMX", "VIMNMX3"),
    "local": ("LDL", "STL"),
    "barrier": ("BAR", "SYNCS", "MEMBAR", "DEPBAR", "ARRIVES"),
    "branch": ("BRA", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "CALL", "RET",
               "BREAK", "JMP", "BRX", "YIELD"),
}
CLASS_OF = {op: cls for cls, ops in CLASSES.items() for op in ops}
WIRE = {"f": "float", "6__half": "__half", "13__nv_bfloat16": "__nv_bfloat16",
        "12__nv_fp8_e4m3": "__nv_fp8_e4m3", "12__nv_fp8_e5m2": "__nv_fp8_e5m2"}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
FUNC = re.compile(r"Function : (\S+)")
NAME = re.compile(r"bp_dual_kernel(I.*?)EEv")


def instance(mangled: str):
    """(wire type, (TI, TJ, TK)) of a mangled bp_dual_kernel instance."""
    m = NAME.search(mangled)
    if not m:
        return None
    args = m.group(1)[1:]
    for code, name in WIRE.items():
        if args.startswith(code):
            tile = tuple(int(x) for x in re.findall(r"Li(\d+)E", args))
            return name, tile
    return None


def functions(sass: str):
    """{mangled name: [(address, predicate, opcode, operands)]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = INSN.search(line)
        if m and cur is not None:
            out_line = (int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4).strip())
            cur.append(out_line)
    return out


def is_tap_load(op: str) -> bool:
    return op.startswith("LDS") and not (".64" in op or ".128" in op)


BRANCHES = ("BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BREAK")


def staged_loop(insns):
    """Index range [lo, hi) of the staged gather in `insns`: of the basic
    blocks that hold no global load or copy and no shared store, the one
    with the most tap loads."""
    targets = {int(x, 16) for _, _, op, rest in insns
               if op.startswith(BRANCHES)
               for x in re.findall(r"0x([0-9a-f]+)", rest)}
    cuts = {0, len(insns)}
    for n, (addr, _, op, _) in enumerate(insns):
        if addr in targets:
            cuts.add(n)
        if op.startswith(BRANCHES):
            cuts.add(n + 1)
    cuts = sorted(cuts)
    best, most = None, 0
    for lo, hi in zip(cuts, cuts[1:]):
        ops = [op for _, _, op, _ in insns[lo:hi]]
        if any(op.startswith(("LDG", "STS", "STG")) for op in ops):
            continue
        taps = sum(is_tap_load(op) for op in ops)
        if taps > most:
            best, most = (lo, hi), taps
    return best


def warps_of(source: Path) -> int:
    m = re.search(r"constexpr int kWarps = (\d+);", source.read_text())
    if not m:
        raise SystemExit(f"no `constexpr int kWarps` in {source}")
    return int(m.group(1))


def ptxas(log: str):
    """{mangled name: (registers, spill store bytes, spill load bytes)}."""
    out, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)),) + spill
    return out


def build(source: Path):
    """(library path, its ptxas report) of `source`, built by the port's
    CudaLibrary (cached by content under build/kernels/)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import CudaLibrary
    lib = CudaLibrary("backproject", [source])
    path = lib.build()
    return path, lib.log_path.read_text()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--sass", type=Path, help="a saved SASS listing")
    ap.add_argument("--log", type=Path, help="its build's ptxas report")
    args = ap.parse_args()
    warps = warps_of(args.source)
    if args.sass is not None:
        sass = args.sass.read_text()
        log = args.log.read_text() if args.log is not None else ""
    else:
        path, log = build(args.source)
        cuobjdump = shutil.which("cuobjdump") or \
            "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                              capture_output=True, text=True).stdout
    regs = ptxas(log)
    cols = ["lds", "conversion", "fp32", "fp16", "integer", "local",
            "barrier", "branch", "other"]
    print("instance | pairs/thread | " + " | ".join(cols)
          + " | total per pair | registers | spill st/ld B")
    rows = 0
    for name, insns in sorted(functions(sass).items()):
        inst = instance(name)
        if inst is None:
            continue
        wire, (ti, tj, tk) = inst
        pairs = ti * tj // warps * (tk // 32)
        span = staged_loop(insns)
        if span is None:
            continue
        count = Counter(CLASS_OF.get(op.split(".")[0], "other")
                        for _, _, op, _ in insns[span[0]:span[1]])
        total = sum(count.values())
        r = regs.get(name)
        print(f"bp_dual_kernel<{wire}, {ti}, {tj}, {tk}> | {pairs} | "
              + " | ".join(f"{count[c] / pairs:.2f}" for c in cols)
              + f" | {total / pairs:.2f} | "
              + (f"{r[0]} | {r[1]}/{r[2]}" if r else "- | -"))
        rows += 1
    if not rows:
        print("no bp_dual_kernel instance found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
