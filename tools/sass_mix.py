"""The instruction mix of a kernel's level loop, from the SASS of the built
library.

    python3 tools/sass_mix.py [kernel] [--sass FILE] [--save FILE]

Builds the kernels of ecrad_torch/csrc (ecrad_torch.kernels.build), or
reads a listing saved earlier (--sass), and disassembles them with
`cuobjdump -sass` (the CUDA toolkit's; --save keeps the listing).  For
each function whose name holds `kernel` (default generator_draw_scan_kernel,
the McICA generator; f32 and f64), finds its loops (the spans that end in
a backward branch), and prints for the longest one its instructions, its
global stores (one per level in the generator, so the levels an
iteration covers) and the instructions per level by opcode.
That is the code the card runs per (column, layer, g-point), to hold
against chip_smoke.py's INT_OPS, the least the work needs.
"""

import argparse
import collections
import os
import re
import subprocess
import sys

INSTR = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNCTION = re.compile(r"Function\s*:\s*(\S+)")


def functions(sass):
    """{mangled name: [(address, opcode, operands)]}, with branch targets
    as addresses whether the listing prints addresses or labels."""
    out, name, labels = {}, None, {}
    pending = []
    for line in sass.splitlines():
        m = FUNCTION.search(line)
        if m:
            name, labels, pending = m.group(1), {}, []
            out[name] = []
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[label] = addr
        pending = []
        words = m.group(2).split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            out[name].append((addr, words[0], " ".join(words[1:]), labels))
    return {n: [(a, op, _target(rest, labels) if op.startswith("BRA")
                 else None) for a, op, rest, labels in body]
            for n, body in out.items()}


def _target(operands, labels):
    m = re.search(r"\(?(\.L_x_\d+)\)?", operands)
    if m:
        return labels.get(m.group(1))
    m = re.search(r"0x([0-9a-fA-F]+)", operands)
    return int(m.group(1), 16) if m else None


def loops(body):
    """[(start, end)] addresses of the spans that end in a backward
    branch."""
    return [(t, a) for a, op, t in body if t is not None and t < a]


def mix(body, kernel):
    spans = loops(body)
    if not spans:
        return f"{kernel}: no loop"
    start, end = max(spans, key=lambda s: s[1] - s[0])
    ops = [op for a, op, _ in body if start <= a <= end]
    stores = sum(op.startswith("STG") for op in ops)
    by_op = collections.Counter(op.split(".")[0] for op in ops)
    per = max(stores, 1)
    return (f"{kernel}: loop 0x{start:x}-0x{end:x}, {len(ops)} instructions,"
            f" {stores} global stores; per store {len(ops) / per:.1f}: "
            + ", ".join(f"{k} {v / per:.2f}" for k, v in by_op.most_common()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", nargs="?", default="generator_draw_scan_kernel")
    ap.add_argument("--sass", help="a saved cuobjdump -sass listing")
    ap.add_argument("--save", help="write the listing here")
    a = ap.parse_args()
    if a.sass:
        with open(a.sass) as f:
            sass = f.read()
    else:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from ecrad_torch import kernels
        cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", kernels.build()["path"]],
                              capture_output=True, text=True,
                              check=True).stdout
    if a.save:
        with open(a.save, "w") as f:
            f.write(sass)
    found = {n: b for n, b in functions(sass).items() if a.kernel in n}
    if not found:
        raise SystemExit(f"no function named like {a.kernel}")
    for name, body in sorted(found.items()):
        print(mix(body, name))


if __name__ == "__main__":
    main()
