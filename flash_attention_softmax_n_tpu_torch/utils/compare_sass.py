"""Compare the SASS of the port's kernels between two checkouts.

Compiles each ``csrc/*.cu`` of both roots with ``nvcc -cubin`` and the
build's flags (``kernels/_build.NVCC_FLAGS``), splits ``cuobjdump -sass`` at
each ``Function :``, and compares every function the two share,
instruction by instruction, with the encodings and addresses left out and
the names demangled, the anonymous namespace's, ``qmm_tile::`` and
``attn::`` dropped (a type that moved into a shared header keeps its
function's name).
Needs the CUDA toolkit; run on the machine with the card, for example
against the parent unpacked by ``git archive`` into ``tmp_parent``::

    python flash_attention_softmax_n_tpu_torch/utils/compare_sass.py --other tmp_parent

Prints one JSON line: for each source, the functions both have, those whose
SASS differs, and those only one has. ``--out`` also writes each differing
function's two listings.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(HERE))

from flash_attention_softmax_n_tpu_torch.kernels import _build  # noqa: E402

_ENCODING = re.compile(r"/\*[^*]*\*/")
_NAMESPACES = re.compile(r"\(anonymous namespace\)::|<unnamed>::|qmm_tile::|(?<!\w)attn::|"
                         r"_GLOBAL__N__[0-9a-f_]+")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    return found


def _demangle(names):
    tool = shutil.which("cu++filt") or str(Path("/usr/local/cuda/bin/cu++filt"))
    if not Path(tool).exists():
        tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def functions(cubin: Path):
    """{normalized name: [instructions]} of one cubin"""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    raw, current = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = head.group(1)
            raw[current] = []
        elif current is not None:
            text = _ENCODING.sub("", line).strip()
            if text and not text.startswith(".") and text not in ("{", "}"):
                raw[current].append(text.rstrip(" ;"))
    names = list(raw)
    return {_NAMESPACES.sub("", d): raw[n] for n, d in zip(names, _demangle(names))}


def compile_cubin(root: Path, source: str, out: Path) -> Path:
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [_tool("nvcc"), *flags, "-cubin", str(root / "flash_attention_softmax_n_tpu_torch"
                                                / "csrc" / source), "-o", str(out)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--root", default=str(HERE), help="this side's root (default: this checkout)")
    ap.add_argument("--sources", nargs="*", default=list(_build.KERNELS))
    ap.add_argument("--out", default=None, help="write differing listings here (JSON)")
    args = ap.parse_args(argv)
    roots = {"root": Path(args.root).resolve(), "other": Path(args.other).resolve()}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        with ThreadPoolExecutor(max_workers=8) as pool:
            for side, root in roots.items():
                for src in args.sources:
                    if (root / "flash_attention_softmax_n_tpu_torch" / "csrc" / src).exists():
                        out = Path(tmp) / f"{side}_{src}.cubin"
                        jobs[(side, src)] = pool.submit(compile_cubin, root, src, out)
        cubins = {key: job.result() for key, job in jobs.items()}
        report, listings = {}, {}
        for src in args.sources:
            a = functions(cubins[("root", src)]) if ("root", src) in cubins else {}
            b = functions(cubins[("other", src)]) if ("other", src) in cubins else {}
            common = sorted(set(a) & set(b))
            differ = [n for n in common if a[n] != b[n]]
            report[src] = {"common": len(common), "identical": len(common) - len(differ),
                           "differ": differ, "only_root": sorted(set(a) - set(b)),
                           "only_other": sorted(set(b) - set(a))}
            for n in differ:
                listings[f"{src}: {n}"] = {"root": a[n], "other": b[n]}
    print(json.dumps({"sass": report}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(listings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
