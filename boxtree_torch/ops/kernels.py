"""Build, bind and count the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled with ``nvcc`` into one shared library with a plain
C interface the first time a CUDA tensor needs one (one ``nvcc`` per
source, all started together, then one link), and loaded with
:mod:`ctypes`.  The library goes to ``build/boxtree_torch/<hash>/`` under the
checkout, keyed by a hash of the sources and flags, so a fresh checkout
builds everything itself and an edited source rebuilds.  A failed build
raises with the compiler's output; nothing falls back to the plain PyTorch
versions.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
its sizes as ``long long`` and its real parameters as ``double``, launches
on PyTorch's current stream, and returns ``cudaGetLastError()``;
:func:`launch` checks the arguments before it builds anything, raises if
the entry point returns non-zero, and otherwise adds one to the entry
point's launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "boxtree_torch"
LIBRARY_NAME = "libboxtree_torch_kernels.so"

#: dynamic shared memory a CTA may opt in to on sm_90 (227 KiB)
SMEM_MAX = 227 * 1024

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> C argument kinds ('p' pointer, 'i' long long, 'd'
#: double); every entry point takes the CUDA stream as a trailing pointer
SIGNATURES = {
    "morton_encode": "pippiiipp",
    "p2p_laplace3d": "pipippppppipppp",
    "m2p_laplace3d": "pipppippppipipp",
    "p2l_laplace3d": "pippppipppipipp",
    "restrict_demand": "pipiiippppppp",
    "area_query_sweep": "ppipippippppippppp",
    "space_invader_sweep": "ppipippippppippppp",
    "peer_lists": "pppiiipppip",
    "p2p_helmholtz3d": "pipippppppippdpp",
    "m2p_helmholtz3d": "pipppippppipdipp",
    "p2l_helmholtz3d": "pippppipppippdipp",
    "stick_levels": "ppippiiidpp",
    "box_extents": "ppiippppiiiippp",
    "list4_ext": "piippppppipddippppppip",
    "list3_ext": "iipppppppppddpiiiipppppp",
    "p2p_helmholtz2d": "pipippppppippdpp",
    "m2p_helmholtz2d": "pipppippppipdiiipppp",
    "p2l_helmholtz2d": "pippppipppipdiiipppp",
    "p2p_laplace2d": "pipippppppipppp",
    "m2p_laplace2d": "pipppippppipipp",
    "p2l_laplace2d": "pippppipppipipp",
    "p2p_laplace3d_dipole": "pipipppppppipppp",
    "p2l_laplace3d_dipole": "pipppppipppipipp",
    "neighbor_table": "ppppppiiiip",
    "row_lists_sl_l2": "ppppppiiiippppppip",
    "lists_43": "ppppppiiiippppppip",
    "list1": "pppppppiiiiipppip",
    "p2m_laplace3d": "pippppipipipp",
    "p2m_laplace3d_dipole": "pipppppipipipp",
    "l2p_laplace3d": "pipppippipipp",
    "p2m_helmholtz3d": "pippppipippdipp",
    "l2p_helmholtz3d": "pipppippipdipp",
    "p2m_helmholtz2d": "pippppipipdiiipppp",
    "l2p_helmholtz2d": "pipppippipdiiipppp",
    "m2l_translate": "pppppppiiiipp",
    "m2m_translate": "pppiiiip",
    "l2l_translate": "ppppiiip",
    "p2m_laplace2d": "pippppipipipp",
    "p2m_laplace2d_dipole": "pipppppipipipp",
    "l2p_laplace2d": "pipppippipipp",
    "p2p_laplace2d_dipole": "pipipppppppipppp",
    "p2l_laplace2d_dipole": "pipppppipppipipp",
    "tree_leaf_levels": "pipippiiiiippppp",
    "tree_level_boxes": "pippppp" + "iiiiii" + "p" * 14,
    "restrict_sweep": "pipipp",
    "level_box_counts": "pipiiipp",
    "p2m_helmholtz3d_dipole": "pipppppipippdipp",
    "p2p_helmholtz3d_dipole": "pipipppppppippdpp",
    "p2l_helmholtz3d_dipole": "pipppppipppippdipp",
    "p2m_helmholtz2d_dipole": "pipppppipipdiiipppp",
    "p2p_helmholtz2d_dipole": "pipipppppppippdpp",
    "p2l_helmholtz2d_dipole": "pipppppipppipdiiipppp",
    "m2l_table_3d": "pppiipp",
    "m2l_table_2d": "pppppiipp",
    "m2l_classify_keys": "pppppp" + "iiiiiii" + "pp",
    "m2l_classify_unpack": "ppppiiipppp",
    "m2l_rotate": "p" * 10 + "iii" + "pp",
    "pack_rows": "ppiipp",
    "unpack_rows": "pppiiip",
    "masked_merge": "ppppiiip",
    "bucket_pack": "pipipiiipppp",
    "rebalance_place": "piiippp",
    "permute_serve": "ppipiiippp",
    "permute_unpack": "piiippipp",
    "shard_leaf_levels": "pipipiiiiippp",
    "shard_box_skeleton": "pi" + "p" * 7 + "ip" + "i" * 8 + "p" * 8,
}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.complex128: "c128"}
_FLOATS = (torch.float32, torch.float64)
#: the Helmholtz particle kernels: float64 is the real-pair layout (real
#: charges, ``[re | im]`` coefficient rows, ``(n, 2)`` potentials)
_HELMHOLTZ = (torch.float64, torch.complex128)

#: kernel name -> the dtypes it has an entry point ``<name>_<suffix>``
#: for; an empty tuple marks a kernel on integer data only, with one entry
#: point ``<name>``, launched with ``dtype=None``
DTYPES = {
    "morton_encode": _FLOATS,
    "p2p_laplace3d": (*_FLOATS, torch.complex128),
    "m2p_laplace3d": (*_FLOATS, torch.complex128),
    "p2l_laplace3d": (*_FLOATS, torch.complex128),
    "restrict_demand": (),
    "area_query_sweep": _FLOATS,
    "space_invader_sweep": _FLOATS,
    "peer_lists": (),
    "p2p_helmholtz3d": _HELMHOLTZ,
    "m2p_helmholtz3d": _HELMHOLTZ,
    "p2l_helmholtz3d": _HELMHOLTZ,
    "stick_levels": _FLOATS,
    "box_extents": _FLOATS,
    "list4_ext": _FLOATS,
    "list3_ext": _FLOATS,
    "p2p_helmholtz2d": _HELMHOLTZ,
    "m2p_helmholtz2d": _HELMHOLTZ,
    "p2l_helmholtz2d": _HELMHOLTZ,
    "p2p_laplace2d": (*_FLOATS, torch.complex128),
    "m2p_laplace2d": (*_FLOATS, torch.complex128),
    "p2l_laplace2d": (*_FLOATS, torch.complex128),
    "p2p_laplace3d_dipole": (*_FLOATS, torch.complex128),
    "p2l_laplace3d_dipole": (*_FLOATS, torch.complex128),
    "neighbor_table": (),
    "row_lists_sl_l2": (),
    "lists_43": (),
    "list1": (),
    "p2m_laplace3d": (*_FLOATS, torch.complex128),
    "p2m_laplace3d_dipole": (*_FLOATS, torch.complex128),
    "l2p_laplace3d": (*_FLOATS, torch.complex128),
    "p2m_helmholtz3d": _HELMHOLTZ,
    "l2p_helmholtz3d": _HELMHOLTZ,
    "p2m_helmholtz2d": _HELMHOLTZ,
    "l2p_helmholtz2d": _HELMHOLTZ,
    "m2l_translate": (*_FLOATS, torch.complex128),
    "m2m_translate": (*_FLOATS, torch.complex128),
    "l2l_translate": (*_FLOATS, torch.complex128),
    "p2m_laplace2d": (*_FLOATS, torch.complex128),
    "p2m_laplace2d_dipole": (*_FLOATS, torch.complex128),
    "l2p_laplace2d": (*_FLOATS, torch.complex128),
    "p2p_laplace2d_dipole": (*_FLOATS, torch.complex128),
    "p2l_laplace2d_dipole": (*_FLOATS, torch.complex128),
    "tree_leaf_levels": (),
    "tree_level_boxes": _FLOATS,
    "restrict_sweep": (),
    "level_box_counts": (),
    "p2m_helmholtz3d_dipole": _HELMHOLTZ,
    "p2p_helmholtz3d_dipole": _HELMHOLTZ,
    "p2l_helmholtz3d_dipole": _HELMHOLTZ,
    "p2m_helmholtz2d_dipole": _HELMHOLTZ,
    "p2p_helmholtz2d_dipole": _HELMHOLTZ,
    "p2l_helmholtz2d_dipole": _HELMHOLTZ,
    "m2l_table_3d": (*_FLOATS, torch.complex128),
    "m2l_table_2d": (*_FLOATS, torch.complex128),
    "m2l_classify_keys": (),
    "m2l_classify_unpack": (),
    "m2l_rotate": (*_FLOATS, torch.complex128),
    "pack_rows": (*_FLOATS, torch.complex128),
    "unpack_rows": (*_FLOATS, torch.complex128),
    "masked_merge": (*_FLOATS, torch.complex128),
    "bucket_pack": (),
    "rebalance_place": (),
    "permute_serve": _FLOATS,
    "permute_unpack": _FLOATS,
    "shard_leaf_levels": (),
    "shard_box_skeleton": (),
}


def _entry_names(name):
    if not DTYPES[name]:
        return [name]
    return [f"{name}_{_SUFFIX[dt]}" for dt in DTYPES[name]]


def _find_nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The compiled kernel library and the launch count of each kernel."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        #: launches by C entry point (``<name>_<suffix>``), which tell a
        #: kernel's layouts apart; :func:`launch_counts` sums them by kernel
        self.launches = {entry: 0 for name in SIGNATURES
                         for entry in _entry_names(name)}
        self.build_seconds = None
        self.build_log = ""
        self.path = None

    def _build(self):
        out_dir = BUILD_DIR / source_hash()
        so_path = out_dir / LIBRARY_NAME
        if not so_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tag = os.getpid()
            nvcc = _find_nvcc()
            t0 = time.perf_counter()
            objs, procs = [], []
            for src in (p for p in _sources() if p.suffix == ".cu"):
                obj = out_dir / f"{src.stem}.{tag}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = []
            for cmd, proc in procs:
                out, _ = proc.communicate()
                logs.append(out)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n"
                        f"{' '.join(cmd)}\n{out}")
            tmp = out_dir / f"{LIBRARY_NAME}.{tag}.tmp"
            cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
            link = subprocess.run(cmd, capture_output=True, text=True,
                                  check=False)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = "".join(logs) + link.stdout + link.stderr
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({link.returncode}):\n"
                    f"{' '.join(cmd)}\n{self.build_log}")
            os.replace(tmp, so_path)
            for obj in objs:
                obj.unlink()
        elif self.build_seconds is None:
            self.build_seconds = 0.0
        return so_path

    def load(self):
        """Build (if needed) and load the library; returns the handle."""
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(str(self.path))
                kinds = {"p": ctypes.c_void_p, "i": ctypes.c_longlong,
                         "d": ctypes.c_double}
                for name, sig in SIGNATURES.items():
                    for entry in _entry_names(name):
                        fn = getattr(lib, entry)
                        fn.argtypes = [kinds[k] for k in sig]
                        fn.restype = ctypes.c_int
                lib.boxtree_torch_error_string.argtypes = [ctypes.c_int]
                lib.boxtree_torch_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, name, dtype, *args):
        """Launch kernel *name* for *dtype* (None for the integer
        kernels): tensors pass as device pointers (a complex tensor as its
        interleaved (re, im) values, so it must be contiguous and carry no
        lazy conjugation), ints as ``long long``, floats as ``double``,
        PyTorch's current stream last."""
        sig = SIGNATURES[name]
        if not DTYPES[name]:
            if dtype is not None:
                raise TypeError(f"{name} takes no float dtype")
            entry = name
        elif dtype in DTYPES[name]:
            entry = f"{name}_{_SUFFIX[dtype]}"
        else:
            raise TypeError(f"{name}: unsupported dtype {dtype}")
        if len(args) != len(sig) - 1:
            raise TypeError(f"{name}: expected {len(sig) - 1} arguments, "
                            f"got {len(args)}")
        cargs = []
        device = None
        for kind, arg in zip(sig, args):
            if kind == "p":
                if not isinstance(arg, torch.Tensor):
                    raise TypeError(f"{name}: expected a tensor argument")
                if arg.is_complex() and not (arg.is_contiguous()
                                             and not arg.is_conj()):
                    raise ValueError(f"{name}: a complex argument must be "
                                     "contiguous and not lazily conjugated")
                device = arg.device
                cargs.append(arg.data_ptr())
            elif kind == "d":
                cargs.append(float(arg))
            else:
                cargs.append(int(arg))
        lib = self.load()
        cargs.append(torch.cuda.current_stream(device).cuda_stream)
        err = getattr(lib, entry)(*cargs)
        if err != 0:
            msg = lib.boxtree_torch_error_string(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg} ({err})")
        self.launches[entry] += 1


_LIBRARY = KernelLibrary()


def build():
    """Build and load the kernel library now; returns it."""
    _LIBRARY.load()
    return _LIBRARY


def launch(name, dtype, *args):
    _LIBRARY.launch(name, dtype, *args)


def launch_counts():
    """Launches by kernel, over all its entry points."""
    return {name: sum(_LIBRARY.launches[entry]
                      for entry in _entry_names(name))
            for name in SIGNATURES}


def entry_launch_counts():
    """Launches by C entry point: ``p2m_helmholtz3d_f64`` apart from
    ``p2m_helmholtz3d_c128``."""
    return dict(_LIBRARY.launches)


def reset_launch_counts():
    for entry in _LIBRARY.launches:
        _LIBRARY.launches[entry] = 0


def check_tensors(*tensors, dtype):
    """The kernels take contiguous CUDA tensors of *dtype* on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel arguments must be CUDA tensors on one "
                             "device")
        if t.dtype != dtype:
            raise TypeError(f"kernel argument of dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
