"""Build the port's CUDA sources at first use and load them with ctypes.

Each source in ``ops/csrc/`` exposes a plain C interface and includes no
PyTorch header, so ``nvcc`` compiles it in seconds. ``torch.utils.
cpp_extension.load`` drives the build (nvcc, then the link) and rebuilds
only when the source or the flags change. Code is generated for Hopper only
(``sm_90a``) and without ``--use_fast_math``. The build goes to
``ops/_build/<name>/``, which git ignores. A failed build raises.
"""

import ctypes
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_libraries = {}


def load_library(name, source, defines=()):
    """Compile ``csrc/<source>`` with the ``-D`` ``defines`` into a shared
    library called ``name`` (once per process and per name), and return it
    as a ``ctypes.CDLL``."""
    if name in _libraries:
        return _libraries[name]
    from torch.utils.cpp_extension import load

    build_dir = BUILD_ROOT / name
    build_dir.mkdir(parents=True, exist_ok=True)
    flags = list(CUDA_FLAGS) + [f"-D{define}" for define in defines]
    path = load(name=name, sources=[str(CSRC / source)], extra_cuda_cflags=flags,
                build_directory=str(build_dir), is_python_module=False)
    lib = ctypes.CDLL(path)
    _libraries[name] = lib
    return lib
