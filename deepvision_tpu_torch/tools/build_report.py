"""What nvcc made of the port's kernels: ptxas's resources and the SASS.

`ptxas_by_function` reads the `-Xptxas -v` report that `ops._build` keeps
for each library it built; `hmma_by_function` counts each kernel's
tensor-core instructions in `cuobjdump -sass` of a built library, which
shows whether a product runs on the tensor cores. Both need the CUDA
toolkit, so they run on the card's host only.
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


def hmma_by_function(library: str) -> dict:
    """{mangled kernel: count of tensor-core (HMMA/HGMMA) instructions in
    its SASS} from `cuobjdump -sass` of a built library."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line.split(";")[0]):
            counts[name] += 1
    return counts
