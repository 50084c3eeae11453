"""Loader for the port's host witness engine (csrc/host_engine.c).

The port of ``halo2_lib_tpu/native.py``, with the same names: the C source is
the port's own copy of ``native/halo2_native.c`` (module ``h2t_host_engine``,
without the host Pippenger), built at first use with ``cc`` into the
git-ignored ``_build/`` under a name keyed by a hash of the compiler, the
flags and the source, and loaded from there. Its ``set_classes`` statics belong to this build alone, so it
emits the port's ``core.cells`` classes even where the JAX package's engine
is loaded in the same process.

``HALO2_NO_NATIVE=1`` (read at the first call, as the JAX package reads it)
selects the Python path for the whole process; ``python_path()`` does so for
a block. The choice lives here alone: every hook asks ``get_region_mod`` or
``get_emitter`` at each call. Otherwise there is no fallback: a missing
compiler or a failed build raises ``RuntimeError`` with the compiler's
output. An emitter's own ``-1`` /
``None`` for one call (a ``WitnessFraction`` input, an oversized
decomposition) hands that call to the Python path, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile

MODULE = "h2t_host_engine"
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_engine.c")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CFLAGS = ["-O3", "-shared", "-fPIC"]

_NATIVE = None
_TRIED = False


def _cc() -> str:
    cc = shutil.which(os.environ.get("CC", "cc"))
    if cc is None:
        raise RuntimeError("no C compiler (cc) found: the host witness engine cannot be built; "
                           "HALO2_NO_NATIVE=1 selects the Python path")
    return cc


def build() -> str:
    """Compile csrc/host_engine.c into ``_build/h2t_host_engine_<hash><ext>``
    unless it exists; returns the path. The hash covers the compiler (its
    path and the first line of its ``--version``), the flags, the include
    path and the source. The build goes to a temporary file that replaces the
    target whole, so parallel processes never load half a library; builds of
    other hashes are removed."""
    cc = _cc()
    version = subprocess.run([cc, "--version"], capture_output=True, text=True).stdout
    include = sysconfig.get_path("include")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = "\0".join([cc, version.split("\n", 1)[0], *CFLAGS, include]).encode()
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(key + b"\0" + f.read())
    name = f"{MODULE}_{h.hexdigest()[:16]}{suffix}"
    so = os.path.join(BUILD_DIR, name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=MODULE + "_", suffix=".tmp")
    os.close(fd)
    try:
        res = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE, f"-I{include}"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"cc failed on {SOURCE}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for f in os.listdir(BUILD_DIR):
        if f.startswith(MODULE + "_") and f.endswith(suffix) and f != name:
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(BUILD_DIR, f))
    return so


def _load(path: str):
    spec = importlib.util.spec_from_file_location(MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def get_native():
    """The h2t_host_engine module, the port's cell classes registered, or
    None under HALO2_NO_NATIVE=1 (or inside python_path()). Builds it at the
    first call; raises if that fails."""
    global _NATIVE, _TRIED
    if _TRIED:
        return _NATIVE
    if os.environ.get("HALO2_NO_NATIVE") != "1":
        mod = _load(build())
        _register_classes(mod)
        _NATIVE = mod
    _TRIED = True
    return _NATIVE


# the JAX name of the module that Context.assign_region calls (emit_region)
get_region_mod = get_native


_EMITTERS: dict[int, "NativeEmitter"] = {}
_CLASSES_SET = False


def _register_classes(mod) -> None:
    """Hand the eDSL cell classes to the C module (once)."""
    global _CLASSES_SET
    if not _CLASSES_SET:
        from .core.cells import AssignedValue, ContextCell, QCell

        mod.set_classes(ContextCell, QCell, AssignedValue)
        _CLASSES_SET = True


def get_emitter(p: int):
    """Per-field native cell emitter, or None on the Python path."""
    mod = get_native()
    if mod is None:
        return None
    em = _EMITTERS.get(p)
    if em is None:
        em = _EMITTERS[p] = NativeEmitter(p, mod)
    return em


@contextlib.contextmanager
def python_path():
    """Inside this block every hook takes the Python path, as under
    HALO2_NO_NATIVE=1: Context.assign_region, every gate chip's
    inner_product, range_check and _u16_cols."""
    global _NATIVE, _TRIED
    saved = _NATIVE, _TRIED
    _NATIVE, _TRIED = None, True
    try:
        yield
    finally:
        _NATIVE, _TRIED = saved


class NativeEmitter:
    """Bulk emitters for hot gadget cell layouts (native witness engine).

    Python keeps the layout spec and the fallback path; a C call does the
    per-cell work (field arithmetic, advice/selector appends, copy tuples).
    """

    __slots__ = ("_p", "_r2", "mod")

    def __init__(self, p: int, mod):
        self._p = p.to_bytes(32, "little")
        self._r2 = pow(2, 512, p).to_bytes(32, "little")
        self.mod = mod

    def inner_product(self, ctx, a: list, b: list) -> int:
        """Emit the running-sum inner product; -1 = caller must fall back,
        else returns the b[0]==Constant(1) flag (0/1)."""
        return self.mod.emit_inner_product(self._p, self._r2, ctx, a, b)

    def range_check(self, ctx, a, limb_bases, num_limbs, lookup_bits, rows):
        """Whole multi-limb range_check (decompose + inner product + lookup
        rows); returns the last-limb AssignedValue, or None = fall back."""
        return self.mod.emit_range_check(
            self._p, self._r2, ctx, a, limb_bases, num_limbs, lookup_bits, rows
        )


def _pack32(values, p) -> bytes:
    return b"".join(int(v % p).to_bytes(32, "little") for v in values)


class NativeField:
    """The engine's gate-column check over a prime < 2^256. The host
    MockProver keeps its Python gate scan: packing a column of Python ints
    for the C check costs more than the scan (PERF.md, chip_smoke.py phase
    8). The engine's modmul_vec / modadd_vec / modsub_vec stay in the C
    source, as in the JAX package's, with no wrapper: nothing calls them."""

    def __init__(self, p: int):
        self.p = p
        self._p_bytes = p.to_bytes(32, "little")
        self._r2_bytes = (pow(2, 512, p)).to_bytes(32, "little")
        self.mod = get_native()

    @property
    def available(self) -> bool:
        return self.mod is not None

    def check_gate_column(self, values: list[int], selectors: list[bool]) -> int:
        """First row where q * (a + b*c - d) != 0, or -1. None on the Python
        path."""
        if self.mod is None:
            return None
        # rows past the selector list are not gated (the Python scan's reading)
        sel_bytes = bytes(1 if s else 0 for s in selectors).ljust(len(values), b"\0")
        col_bytes = _pack32(values, self.p)
        return self.mod.check_gates(
            self._p_bytes, self._r2_bytes, col_bytes, sel_bytes, len(values)
        )
