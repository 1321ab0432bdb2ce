"""Compare the machine code (SASS) of one CUDA source across source trees.

    python visual_rag_tpu_torch/tools/sass_diff.py <source> <tag>=<tree root> ...

compiles ``<tree root>/<source>`` (for example
``visual_rag_tpu_torch/csrc/flash_attention.cu``) of every tree with the
build's own nvcc flags, all at once, into ``build/kernels/sass/<tag>.o``,
dumps each object's SASS with ``cuobjdump -sass`` and prints, for every
kernel of the first tree, whether each other tree has the same SASS lines
(addresses and encodings left out), and the kernel's ptxas registers and
spills. Equal SASS means a timing gap between the trees is not the kernel's
code. Needs nvcc and cuobjdump, so it runs on the card's machine.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path


def sass_by_kernel(text: str) -> dict:
    """{mangled kernel name: its SASS lines without addresses and encodings}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if ins:
                out[name].append(ins)
    return out


def library_sass(path) -> dict:
    """``sass_by_kernel`` of a built object or shared library, by ``cuobjdump -sass``
    from the toolkit of the build's nvcc."""
    from visual_rag_tpu_torch.ops.kernels._build import find_nvcc

    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    return sass_by_kernel(subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                         text=True, check=True).stdout)


def ptxas_by_kernel(log: str) -> dict:
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def main(source: str, trees: dict) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from visual_rag_tpu_torch.ops.kernels._build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    nvcc = find_nvcc()
    out = BUILD_DIR / "sass"
    out.mkdir(parents=True, exist_ok=True)
    procs = {tag: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(out / f"{tag}.o"), str(Path(root) / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tag, root in trees.items()}
    sass, ptxas = {}, {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{tag}: nvcc failed ({proc.returncode})\n{log}")
            return 1
        ptxas[tag] = ptxas_by_kernel(log)
        sass[tag] = library_sass(out / f"{tag}.o")
    first, *others = trees
    for name, code in sorted(sass[first].items()):
        verdicts = []
        for tag in others:
            got = sass[tag].get(name)
            same = "missing" if got is None else "same" if got == code else "DIFFERS"
            verdicts.append(f"{tag} {same}")
        print(f"{name}: {len(code)} lines in {first}; {', '.join(verdicts)}; "
              f"{'; '.join(ptxas[first].get(name, []))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], dict(a.split("=", 1) for a in sys.argv[2:])))
