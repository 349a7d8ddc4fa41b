#!/usr/bin/env python
"""Whether a change leaves the compiled kernels as they were: builds the
kernel libraries of this checkout and of a parent checkout (both with
``ops/kernel_lib.build_kernels``, at the same time), then compares, library
by library, the SASS instruction stream of every function (``cuobjdump
-sass``, addresses and encodings left out) and the registers, stack and
spill lines ``-Xptxas -v`` prints for each kernel. Each checkout builds
afresh into its own ``build/sass_diff/``.

Unpack the parent into a directory that ``.gitignore`` lists, then run from
this checkout's root on the machine with the card (``nvcc`` and
``cuobjdump`` are needed; no GPU is touched):

    git archive <parent> nerf_and_dietnerf_tpu_torch | tar -x -C build/parent
    python -m nerf_and_dietnerf_tpu_torch.tools.sass_diff build/parent

One JSON line per library of the model kernels B1, B2, B4-B7; exits 1 if
any differs. Functions only the change's build has are listed apart
(``added``) and do not count as a difference: a build may add functions
beside unchanged ones. The parsers of both formats (:func:`sass_functions`,
:func:`ptxas_blocks`, :func:`ptxas_entries`) are the ones ``chip_smoke.py``
reads its SASS and register counts with.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_PTXAS = ("entry function", "registers", "spill", "stack frame")


def build_script(subdir: str, libs=None) -> str:
    """Python that builds the libraries ``libs`` (default: all) of the
    checkout it runs in afresh into its ``build/<subdir>/`` (so the
    compiler's log is whole) and prints their paths and that log as JSON."""
    pick = "" if libs is None else (
        f"kl.KERNEL_SOURCES = {{n: kl.KERNEL_SOURCES[n] for n in {list(libs)!r}}}; ")
    return ("import json, shutil; from nerf_and_dietnerf_tpu_torch.ops import kernel_lib as kl; "
            f"kl.BUILD_DIR = kl.BUILD_DIR.parent / {subdir!r}; {pick}"
            "shutil.rmtree(kl.BUILD_DIR, ignore_errors=True); r = kl.build_kernels(); "
            "print(json.dumps({'log': r['log'], 'paths': "
            "{n: str(kl.lib_path(n)) for n in kl.KERNEL_SOURCES}}))")


def build_checkouts(roots: dict, subdir: str, libs=None) -> dict:
    """``{name: {"log": ..., "paths": {library: path}}}``: :func:`build_script`
    run in each checkout of ``roots`` (``{name: root}``), all at the same
    time. Raises if a build fails."""
    procs = {name: subprocess.Popen([sys.executable, "-c", build_script(subdir, libs)],
                                    cwd=str(Path(root).resolve()), stdout=subprocess.PIPE,
                                    text=True)
             for name, root in roots.items()}
    builds = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the {name}'s build failed")
        builds[name] = json.loads(out.strip().splitlines()[-1])
    return builds


def sass_functions(sass: str) -> dict:
    """``{function name: [instruction, ...]}`` of ``cuobjdump -sass`` output."""
    return {part.split("\n", 1)[0].strip(): _INSTRUCTION.findall(part)
            for part in re.split(r"\n\s*Function : ", sass)[1:]}


def ptxas_blocks(build_log: str) -> dict:
    """``{library: [line, ...]}``: the lines of ``build_kernels``' log under
    each ``--- library`` heading (its ``-Xptxas -v`` output)."""
    blocks, block = {}, None
    for line in build_log.splitlines():
        if line.startswith("--- "):
            block = blocks.setdefault(line[4:].strip(), [])
        elif block is not None:
            block.append(line.strip())
    return blocks


def ptxas_entries(lines) -> dict:
    """``{entry: {registers, spill_stores, spill_loads}}`` of every kernel in
    one library's ptxas lines (its own lines, not those of a device function
    the compiler kept out of line)."""
    entry, props, out = None, None, {}
    for line in lines:
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for " in line:
            props = line.split("Function properties for ")[1].strip()
        elif entry and props == entry:
            rec = out.setdefault(entry, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rec.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
    return out


_NAMED = re.compile(r"Compiling entry function '([^']+)'|Function properties for (\S+)")


def _ptxas_lines(build_log: str, lib: str, leave_out=()) -> list:
    """The ptxas lines of one library, those of the functions ``leave_out``
    names (a function's lines run from the line that names it to the next
    such line) left out."""
    lines, keep = [], True
    for line in ptxas_blocks(build_log).get(lib, []):
        named = _NAMED.search(line)
        if named:
            keep = (named.group(1) or named.group(2)) not in leave_out
        if keep and any(k in line for k in _PTXAS):
            lines.append(line)
    return lines


def compare(old: dict, new: dict, old_log: str, new_log: str, lib: str) -> dict:
    """One library: its functions' instruction streams (in any order, names
    aside: a device function kept out of line may change its mangled name
    with a template parameter) and its ptxas lines. A new function whose
    stream no old one has is ``changed`` if an old function has its name,
    else ``added``; added functions and their ptxas lines are left out of
    the verdict."""
    pool = collections.Counter(tuple(v) for v in old.values())
    unmatched = []
    for name, instructions in new.items():
        if pool[tuple(instructions)]:
            pool[tuple(instructions)] -= 1
        else:
            unmatched.append(name)
    added = sorted(n for n in unmatched if n not in old)
    streams = sorted(old.values()) == sorted(v for n, v in new.items() if n not in added)
    ptxas = _ptxas_lines(old_log, lib) == _ptxas_lines(new_log, lib, added)
    return {"library": lib, "functions": [len(old), len(new)],
            "names_equal": sorted(old) == sorted(new), "instructions_equal": streams,
            "instructions": [sum(map(len, old.values())), sum(map(len, new.values()))],
            "ptxas_equal": ptxas, "changed": sorted(n for n in unmatched if n in old),
            "added": added, "same": streams and ptxas}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("parent", type=Path,
                   help="a parent checkout (holding nerf_and_dietnerf_tpu_torch/)")
    args = p.parse_args(argv)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump not found: run this on the machine with the CUDA toolkit", file=sys.stderr)
        return 2
    libs = [n for n in kl.KERNEL_SOURCES if not n.startswith("probe_")]
    here = Path(kl.__file__).resolve().parents[2]
    try:
        builds = build_checkouts({"parent": args.parent, "change": here}, "sass_diff")
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    lines = []
    for lib in libs:
        funcs = {name: sass_functions(subprocess.run(
            [tool, "-sass", b["paths"][lib]], check=True, capture_output=True, text=True).stdout)
            for name, b in builds.items()}
        line = compare(funcs["parent"], funcs["change"], builds["parent"]["log"],
                       builds["change"]["log"], lib)
        lines.append(line)
        print(json.dumps(line), flush=True)
    return 0 if all(line["same"] for line in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
