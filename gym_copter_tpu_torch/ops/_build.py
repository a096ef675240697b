"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
into `_build/lib<name>-<hash>.so` at first use, the hash covering the
source and the flags, so an edited source is rebuilt.  Nothing is built
when this module is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v

`-fmad=false` keeps nvcc from contracting a*b+c into one FMA, so that the
kernels round like their plain PyTorch versions; there is no fast math.
ptxas's report (registers, spills) of each build is kept beside the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / '_build'
SOURCES = ('fused_rollout', 'clip_adam', 'env_step')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

_loaded: dict = {}


def tool(name: str) -> str:
    """A CUDA tool (nvcc, cuobjdump) of $CUDA_HOME, /usr/local/cuda, or the
    PATH."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and (Path(home) / 'bin' / name).is_file():
            return str(Path(home) / 'bin' / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f'{name} not found: set CUDA_HOME or put it on '
                           f'the PATH')
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def ptxas_report(name: str) -> str:
    """What ptxas said about the current build of `name`."""
    return library_path(name).with_suffix('.ptxas.txt').read_text()


def compile_source(source: Path, out: Path) -> str:
    """nvcc `source` into the shared library `out`; returns ptxas's
    report."""
    proc = subprocess.run(
        [tool('nvcc'), *NVCC_FLAGS, '-o', str(out), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{proc.stdout}')
    return proc.stdout


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, one nvcc each.
    Returns {name: library path}."""
    BUILD_DIR.mkdir(exist_ok=True)
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        out.with_suffix('.ptxas.txt').write_text(
            compile_source(CSRC / f'{name}.cu', tmp))
        os.replace(tmp, out)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built first if need be."""
    if name not in _loaded:
        path = build_all((name,))[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def error_string(lib: ctypes.CDLL, code: int) -> str:
    fn = lib.gct_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return f'{code} ({fn(code).decode()})'
