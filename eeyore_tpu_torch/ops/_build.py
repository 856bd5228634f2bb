"""Build the port's CUDA sources at first use and load them with ctypes.

Each source in ``ops/csrc/`` exposes a plain C interface and includes no
PyTorch header, so ``nvcc`` compiles it in seconds. ``torch.utils.
cpp_extension.load`` drives the build (nvcc, then the link) and rebuilds
only when the listed source or the flags change; it does not track the
``csrc/*.cuh`` headers a source includes, so a hash of the headers goes into
the library's name, and an edited header never loads a stale build. Code is
generated for Hopper only (``sm_90a``) and without ``--use_fast_math``. The
build goes to ``ops/_build/<name>/``, which git ignores. A failed build
raises ``KernelError``.

A build may also take generated headers (the dense kernels' bodies, which
hold one dataset as constants): they are written into the build directory,
which is on the include path, and their hash goes into the name too, so two
datasets loaded in one process never share a build.

``load_counts`` counts the calls (``loads``) and those that reach
``cpp_extension.load`` (``builds``): a steady job builds nothing. A call is
the span ``eeyore.library``, and each span's record keeps both counts'
increase inside it (``utils/profiling.py``).
"""

import ctypes
import hashlib
from pathlib import Path

from eeyore_tpu_torch.utils.profiling import spanned

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_libraries = {}
load_counts = {"loads": 0, "builds": 0}


class KernelError(RuntimeError):
    """A kernel's build, load or launch failed, or a library reports a CUDA
    error: a fault of the kernel or the card, never of the numbers it was
    given, so no caller retries it as a failed run."""


def headers_hash():
    """Short hash of every ``csrc/*.cuh`` header, by name and content."""
    digest = hashlib.sha256()
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return digest.hexdigest()[:10]


@spanned("eeyore.library")
def load_library(name, source, defines=(), generated=None):
    """Compile ``csrc/<source>`` with the ``-D`` ``defines`` into a shared
    library called ``name`` plus the headers' hash (once per process and per
    name), and return it as a ``ctypes.CDLL``. ``generated``: {file name:
    text} of headers to write beside the build, for the source to include."""
    load_counts["loads"] += 1
    generated = dict(generated or {})
    name = f"{name}_{headers_hash()}"
    if generated:
        digest = hashlib.sha256()
        for file_name, text in sorted(generated.items()):
            digest.update(file_name.encode())
            digest.update(text.encode())
        name = f"{name}_{digest.hexdigest()[:10]}"
    if name in _libraries:
        return _libraries[name]
    from torch.utils.cpp_extension import load

    build_dir = BUILD_ROOT / name
    build_dir.mkdir(parents=True, exist_ok=True)
    for file_name, text in generated.items():
        path = build_dir / file_name
        if not path.exists() or path.read_text() != text:
            path.write_text(text)
    flags = list(CUDA_FLAGS) + [f"-D{define}" for define in defines]
    if generated:
        flags.append(f"-I{build_dir}")
    load_counts["builds"] += 1
    try:
        path = load(name=name, sources=[str(CSRC / source)], extra_cuda_cflags=flags,
                    build_directory=str(build_dir), is_python_module=False)
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as err:
        raise KernelError(f"building {source} as {name} failed: {err}") from err
    _libraries[name] = lib
    return lib
