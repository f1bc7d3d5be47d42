"""Build and load the port's CUDA kernels (``csrc/``) at first use.

The kernels (``csrc/*.cu``) compile with one ``nvcc`` each for ``sm_90a``,
and their PyTorch bindings (``csrc/bindings.cpp``, typed operators
registered with ``TORCH_LIBRARY``) with the host C++ compiler; all start
together. The objects link into one shared library, loaded with
``torch.ops.load_library``, whose operators are ``torch.ops.fasn.*``. Only
the bindings include PyTorch's headers, so ``nvcc`` never parses them and a
build takes seconds. ``launchers.h`` declares the kernels' entry points
for both sides, so the compiler checks every argument list;
``flash_common.h`` holds the device code that the flash-attention kernels
(K1, K5, K6) and the prefill-phase kernel K10 share; ``hopper.h`` the
inline PTX of the tensor-core kernels (TMA, mbarriers, wgmma and its
descriptors) and libcuda's tensor-map encoder, which K7, K1, K5, K6 and
K10 include; ``attn_tile.h`` the TMA + wgmma attention tile of K1's, K5's,
K6's and K10's bf16 kernels; ``qmm_tile.h`` K7's tensor-core dequant matmul
(TMA ring, producer warp, converting consumers), on which K9 and K2's bf16
kernel build too.

The library lands in ``_build/`` beside the package (listed in
``.gitignore``), named by a hash of the sources, flags and PyTorch version,
so an edited source rebuilds and an unchanged one is reused.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` there
and nowhere else, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

__all__ = ["LAUNCHES", "BUILD_SECONDS", "reset_launches", "build", "ops"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu",
           "qmm_argmax.cu", "cache_update.cu", "qmm.cu", "fused_mlp.cu",
           "decode_attn.cu", "prefill_phases.cu")
BINDINGS = "bindings.cpp"
HEADERS = ("launchers.h", "flash_common.h", "hopper.h", "attn_tile.h", "qmm_tile.h")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC"]

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "qmm_argmax": 0,
                            "cache_append": 0, "tail_append": 0, "qmm": 0,
                            "fused_mlp": 0, "decode_attn": 0,
                            # K10, one count per mode
                            "mini_dots_only": 0, "mini_exp_only": 0,
                            "mini_softmax": 0, "mini_mask_softmax": 0}
# wall seconds of each compile and of the link in this process's last build
BUILD_SECONDS: Dict[str, float] = {}

_loaded = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tool(name: str, env: str) -> str:
    found = os.environ.get(env) or shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _torch_flags() -> Tuple[List[str], List[str]]:
    """Include flags for the bindings and link flags for the library."""
    from torch.utils import cpp_extension

    inc = [f"-I{p}" for p in cpp_extension.include_paths(device_type="cuda")]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    lib = str(Path(torch.__file__).resolve().parent / "lib")
    link = [f"-L{lib}", "-Xlinker", "-rpath", "-Xlinker", lib,
            "-lc10", "-lc10_cuda", "-ltorch_cpu"]
    return [abi, *inc], link


def _run_all(cmds: Dict[str, List[str]]) -> Dict[str, str]:
    """Run the commands concurrently; raise with the compiler's output on
    the first failure; record each one's wall time in BUILD_SECONDS and
    return its output."""
    t0 = time.perf_counter()
    logs, failed = {}, None
    pending = {}
    for k, c in cmds.items():
        out = tempfile.TemporaryFile("w+", dir=BUILD_DIR)
        pending[k] = (subprocess.Popen(c, stdout=out, stderr=subprocess.STDOUT,
                                       text=True), out)
    while pending:
        for k, (p, out) in list(pending.items()):
            if p.poll() is None:
                continue
            del pending[k]
            BUILD_SECONDS[k] = time.perf_counter() - t0
            out.seek(0)
            logs[k] = out.read()
            out.close()
            if p.returncode != 0 and failed is None:
                failed = k
        time.sleep(0.05)
    if failed is not None:
        raise RuntimeError(f"kernel build failed: {' '.join(cmds[failed])}\n"
                           f"{logs[failed]}")
    return logs


def build() -> Path:
    """Compile ``csrc/`` into ``_build/libfasn_<hash>.so`` unless present."""
    inc, link = _torch_flags()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS + inc + link
                                     + [torch.__version__]).encode())
    for name in (*KERNELS, BINDINGS, *HEADERS):
        digest.update((CSRC / name).read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libfasn_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, cxx = _tool("nvcc", "NVCC"), _tool("c++", "CXX")
    # per-process object names: concurrent first uses must not share files
    obj = {n: BUILD_DIR / f"{Path(n).stem}_{tag}_{os.getpid()}.o"
           for n in (*KERNELS, BINDINGS)}
    cmds = {n: [nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", str(obj[n])]
            for n in KERNELS}
    cmds[BINDINGS] = [cxx, *CXX_FLAGS, *inc, "-c", str(CSRC / BINDINGS),
                      "-o", str(obj[BINDINGS])]
    BUILD_SECONDS.clear()
    logs = _run_all(cmds)
    (BUILD_DIR / f"ptxas_{tag}.log").write_text(
        "\n".join(logs[n] for n in KERNELS))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    # the CUDA runtime links statically (nvcc's default), so loading the
    # library does not depend on where the toolkit's shared runtime lives
    _run_all({"link": [nvcc, "-shared", "-o", str(tmp),
                       *map(str, obj.values()), *link]})
    for o in obj.values():
        o.unlink()
    os.replace(tmp, lib_path)
    return lib_path


def ops():
    """The kernels' operators, ``torch.ops.fasn``, building them on first
    use."""
    global _loaded
    if not _loaded:
        torch.ops.load_library(str(build()))
        _loaded = True
    return torch.ops.fasn
