#!/usr/bin/env python3
"""What ptxas and the SASS say about the port's kernels.

    python3 scripts/sass_report.py [SOURCE ...]   # from the root of a
                                                  # checkout, where nvcc is

Compiles each source of `src/repro_torch/csrc` (default: flash_attention,
qgemm, qgemm_f64, qmv and trisolve) alone, with the flags of
`repro_torch.kernels.library` and `-Xptxas -v`, all at once, then
disassembles each object with `cuobjdump -sass`. Prints, per kernel: its
registers, spill stores and loads, the ptxas notes C7514, C7515, C7517
and C7518 (a wgmma serialised, or a wait injected, because the code
reads or writes an accumulator where a wgmma in flight may), and how
many HGMMA, FFMA, MUFU.EX2, SHFL and BAR instructions its SASS holds;
then, for each innermost loop of the SASS (a backward branch and its
target, holding no other) that holds a SHFL, its instructions and its
SHFL and BAR counts: in trisolve these are the row chain and the tile
rows, whose trees should shuffle without a barrier. Nothing runs on the card;
exits 1 if a compile fails.
"""
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

COUNTED = ("HGMMA", "FFMA", "MUFU.EX2", "SHFL", "BAR")


def nvcc_bin(tool):
    from repro_torch.kernels import library
    return os.path.join(os.path.dirname(library._nvcc()), tool)


def short(mangled):
    """The kernel's name with its template arguments (cu++filt)."""
    try:
        text = subprocess.run([nvcc_bin("cu++filt"), mangled],
                              capture_output=True, text=True).stdout
    except OSError:
        return mangled
    m = re.search(r"::(\w+(?:<[^>]*>)?)\(", text)
    return m.group(1) if m else mangled


def compile_one(source, out_dir):
    from repro_torch.kernels import library
    flags = [f for f in library.NVCC_FLAGS if f != "-shared"]
    obj = os.path.join(out_dir, source + ".o")
    src = str(library.CSRC / (source + ".cu"))
    proc = subprocess.run([library._nvcc(), *flags, "-Xptxas", "-v", "-c",
                           "-o", obj, src], capture_output=True, text=True)
    return source, obj, proc


def ptxas_facts(text):
    """{kernel: dict(registers, spill_stores, spill_loads, notes)}."""
    facts, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            facts[current] = dict(registers=None, spill_stores=None,
                                  spill_loads=None, notes=[])
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            facts.setdefault(current, dict(registers=None, spill_stores=None,
                                           spill_loads=None, notes=[]))
            continue
        m = re.search(r"\(C75\d\d\).*?function '(\w+)'", line)
        if m:
            name = m.group(1)
            code = re.search(r"C75\d\d", line).group(0)
            facts.setdefault(name, dict(registers=None, spill_stores=None,
                                        spill_loads=None, notes=[]))
            facts[name]["notes"].append(code)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            facts[current]["spill_stores"] = int(m.group(1))
            facts[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts[current]["registers"] = int(m.group(1))
    return facts


def sass_counts(obj):
    """{kernel: {instruction: count}} and {kernel: [loop, ...]} from
    cuobjdump -sass, a loop being (instructions, {instruction: count})
    between a backward branch's target and the branch, for the loops
    that hold a SHFL."""
    text = subprocess.run([nvcc_bin("cuobjdump"), "-sass", obj],
                          capture_output=True, text=True, check=True).stdout
    counts, code, current = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1)
            counts[current] = {k: 0 for k in COUNTED}
            code[current] = []
            continue
        if current is None:
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            code[current].append((int(m.group(1), 16), m.group(2)))
        for k in COUNTED:
            if re.search(r"\b" + re.escape(k) + r"\b", line):
                counts[current][k] += 1
    loops = {}
    for name, ins in code.items():
        spans = set()
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                spans.add((int(m.group(1), 16), addr))
        # Innermost loops only: a span holding another is an outer loop,
        # or a jump back from a slow path placed after the code.
        for lo, hi in sorted(spans):
            if any((lo, hi) != (a, b) and lo <= a and b <= hi
                   for a, b in spans):
                continue
            body = [t for a, t in ins if lo <= a <= hi]
            c = {k: sum(bool(re.search(r"\b" + re.escape(k) + r"\b", t))
                        for t in body) for k in ("SHFL", "BAR")}
            if c["SHFL"]:
                loops.setdefault(name, []).append((len(body), c))
    return counts, loops


def main():
    sources = sys.argv[1:] or ["flash_attention", "qgemm", "qgemm_f64", "qmv",
                               "trisolve"]
    failed = False
    with tempfile.TemporaryDirectory() as out_dir, \
            ThreadPoolExecutor(len(sources)) as pool:
        for source, obj, proc in pool.map(
                lambda s: compile_one(s, out_dir), sources):
            if proc.returncode != 0:
                print(f"{source}: nvcc failed (rc {proc.returncode})\n"
                      f"{proc.stderr[-4000:]}")
                failed = True
                continue
            facts = ptxas_facts(proc.stdout + proc.stderr)
            counts, loops = sass_counts(obj)
            print(f"{source}.cu:")
            for name in sorted(set(facts) | set(counts)):
                f = facts.get(name, {})
                c = counts.get(name, {})
                print(f"  {short(name)}: {f.get('registers')} registers, "
                      f"spill stores {f.get('spill_stores')} B, loads "
                      f"{f.get('spill_loads')} B, ptxas notes "
                      f"{f.get('notes') or 'none'}; SASS "
                      + ", ".join(f"{k} {c.get(k, 0)}" for k in COUNTED))
                for size, lc in loops.get(name, []):
                    print(f"    loop of {size} instructions: SHFL "
                          f"{lc['SHFL']}, BAR {lc['BAR']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
