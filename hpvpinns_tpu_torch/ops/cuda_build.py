"""Build the package's CUDA C++ sources at first use.

`nvcc` compiles each library from `hpvpinns_tpu_torch/csrc/` into a shared
library with a plain C interface, for sm_90a, which `ctypes` loads: one
`nvcc -c` per source, all started together, then one link.  The output goes
to `hpvpinns_tpu_torch/_build/` under a name keyed by a hash of the sources,
the headers of csrc/ and the flags, so a changed source rebuilds and an
unchanged one is reused.  A failed build raises with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# IEEE fp32 math: no --use_fast_math (it approximates tanhf/sinf).
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was reused
    log: str  # nvcc/ptxas output of the build that made `path`


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=900)


def build_library(name: str, sources) -> BuiltLibrary:
    """Compile `sources` (paths under csrc/, which may include its .cuh
    headers) into `_build/<name>-<hash>.so` unless that file exists, then
    load it."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({h for src in sources for h in src.parent.glob("*.cuh")})
    for src in [*sources, *headers]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        objs = [so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o") for src in sources]
        nvcc = find_nvcc()
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            procs = list(pool.map(_run, cmds))
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(p.returncode == 0 for p in procs):
            cmds.append(link)
            procs.append(_run(link))
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, proc in zip(cmds, procs):
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
        log_path.write_text("".join(p.stdout + p.stderr for p in procs))
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(lib=ctypes.CDLL(str(so)), path=so, build_seconds=seconds, log=log)
