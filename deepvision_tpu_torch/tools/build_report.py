"""What nvcc made of the port's kernels: ptxas's resources and the SASS.

`ptxas_by_function` reads the `-Xptxas -v` report that `ops._build` keeps
for each library it built; `sass_by_function` lists each kernel's
instructions from `cuobjdump -sass` of a built library. From that listing
`count_opcodes` counts instructions by opcode (HMMA shows whether a
product runs on the tensor cores), and `loop_report` counts the
instructions of a kernel's innermost loop, which says what one iteration
costs. The listing needs the CUDA toolkit, so it is taken on the card's
host only.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess


def _tool(name: str) -> str:
    return shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def demangle(names):
    """C++ names of mangled kernel symbols (cu++filt), else as they are."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        plain = out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return plain if len(plain) == len(names) else list(names)


def ptxas_by_function(report: str) -> dict:
    """nvcc -Xptxas -v output -> {mangled kernel: its registers, shared
    memory and spill lines}."""
    info, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            info[name] = []
        elif name and ("spill" in line or "Used" in line):
            info[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in info.items()}


def sass_by_function(library: str) -> dict:
    """{mangled kernel: [(address, instruction), ...]} from `cuobjdump
    -sass` of a built library; an instruction keeps its predicate and
    operands, without the trailing `;` and encoding."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    return parse_sass(sass)


def parse_sass(sass: str) -> dict:
    """`sass_by_function` of a `cuobjdump -sass` listing given as text.
    Branch targets are kept as addresses: a label line (`.L_x_3:`) names
    the address of the instruction after it, and a branch to that label
    is rewritten to a branch to that address."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            labels[name] = {}
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L\w+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    for name, instrs in funcs.items():
        funcs[name] = [(addr, re.sub(
            r"`\((\.L\w+)\)",
            lambda m, n=name: hex(labels[n].get(m.group(1), -1)), text))
            for addr, text in instrs]
    return funcs


def opcode(instruction: str) -> str:
    """`@!P0 FMNMX.NAN R1, R2, R3` -> `FMNMX.NAN`."""
    words = instruction.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def count_opcodes(instrs, pattern: str) -> int:
    """Instructions of a `sass_by_function` listing whose opcode matches
    the regular expression `pattern` at its start."""
    return sum(bool(re.match(pattern, opcode(text))) for _, text in instrs)



def loop_report(instrs, marker: str) -> dict:
    """The innermost loop (a backward branch whose range holds no other)
    with the most `marker` instructions (an opcode prefix, say `MUFU.RCP`
    for one division per pair): its length in instructions, its count of
    `marker` and of each opcode family (the opcode up to its first dot).
    Empty when no innermost loop holds `marker`."""
    loops = []
    for addr, text in instrs:
        m = re.search(r"\bBRA\s+(?:\S+,\s*)?(0x[0-9a-f]+)", text)
        if m and opcode(text).startswith("BRA"):
            target = int(m.group(1), 16)
            if 0 <= target <= addr:
                loops.append((target, addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in loops)]
    best = {}
    for a, b in inner:
        body = [opcode(t) for addr, t in instrs if a <= addr <= b]
        hits = sum(op.startswith(marker) for op in body)
        if hits and hits > best.get(marker, 0):
            families: dict = {}
            for op in body:
                fam = op.split(".")[0]
                families[fam] = families.get(fam, 0) + 1
            best = {"instructions": len(body), marker: hits,
                    "by_opcode": dict(sorted(families.items(),
                                             key=lambda kv: -kv[1]))}
    return best
