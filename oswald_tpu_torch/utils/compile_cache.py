"""Where the kernel libraries are built and kept: the port's counterpart of
oswald_tpu/utils/compile_cache.py.

The JAX package keeps compiled XLA programs in a persistent cache; the port
has one compiled artifact per kernel, a shared library that
`kernels.build` makes with nvcc on first use and names after a hash of its
sources and flags.  This module says in which directory those libraries
live, so that a restarted server, the next CLI run or a fresh deployment
loads them instead of running nvcc again, and packs a warmed directory into
one tarball that another machine unpacks.

Resolution order of the directory (first hit wins):
  1. the `cache_dir` argument (the CLI's --compile-cache DIR);
  2. the OSWALD_TPU_TORCH_COMPILE_CACHE env var;
  3. $XDG_CACHE_HOME/oswald-tpu-torch/kernels, else
     ~/.cache/oswald-tpu-torch/kernels.
Without an argument, the env var set to "0", "", "off", "false" or "no"
disables the cache, as --no-compile-cache does: the libraries then go to a temporary directory of
this process, removed at exit, so every run builds anew.  Until something
is enabled, `kernels.build` uses the default of 3.
"""

import atexit
import os
import shutil
import sys
import tempfile

_ENV = "OSWALD_TPU_TORCH_COMPILE_CACHE"
_OFF = ("", "0", "off", "false", "no")
_DEFAULT_SUBDIR = os.path.join("oswald-tpu-torch", "kernels")

# the directory enable_compile_cache / disable_compile_cache chose
_enabled_dir: str | None = None
# this process's own temporary directory while the cache is disabled
_temp_dir: str | None = None


def default_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, _DEFAULT_SUBDIR)


def current_dir() -> str:
    """The directory the kernel libraries are built into and loaded from."""
    return _enabled_dir or default_cache_dir()


def disable_compile_cache() -> str:
    """Build into a temporary directory of this process, removed when it
    exits (one per process, never shared).  Returns it."""
    global _enabled_dir, _temp_dir
    if _temp_dir is None:
        _temp_dir = tempfile.mkdtemp(prefix="oswald-tpu-torch-kernels-")
        atexit.register(shutil.rmtree, _temp_dir, True)
    _enabled_dir = _temp_dir
    return _temp_dir


def enable_compile_cache(cache_dir: str | None = None,
                         quiet: bool = False) -> str | None:
    """Point the kernel build at `cache_dir` (resolved as the module says)
    and create it.  Returns the directory in use, or None when the cache is
    disabled (by the env var, or because the directory cannot be made);
    the build then uses a temporary directory of this process."""
    global _enabled_dir
    if cache_dir is None:
        env = os.environ.get(_ENV)
        if env is not None and env.strip().lower() in _OFF:
            disable_compile_cache()
            return None
        cache_dir = env or default_cache_dir()
    cache_dir = os.path.abspath(cache_dir)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        if not quiet:
            print(f"oswald-tpu-torch: kernel cache disabled ({e})",
                  file=sys.stderr)
        disable_compile_cache()
        return None
    if not quiet and _enabled_dir != cache_dir:
        print(f"oswald-tpu-torch: kernel cache at {cache_dir}",
              file=sys.stderr)
    _enabled_dir = cache_dir
    return cache_dir


def pack_cache(tar_path: str, cache_dir: str | None = None) -> dict:
    """Archive a warmed kernel directory into one gzip tarball, which a
    fresh deployment unpacks (`unpack_cache`) to skip nvcc.  A library
    loads only where its name's hash of sources and flags matches, so a
    tarball from another checkout of other sources builds anew.  Returns
    {"entries", "bytes", "tar"}."""
    import tarfile
    d = cache_dir or current_dir()
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"kernel cache directory {d} does not exist — run a search/"
            "serve/tune once on a card (with the cache enabled) to "
            "populate it")
    n = size = 0
    with tarfile.open(tar_path, "w:gz") as tf:
        for root, _, files in os.walk(d):
            for f in sorted(files):
                p = os.path.join(root, f)
                tf.add(p, arcname=os.path.relpath(p, d))
                size += os.path.getsize(p)
                n += 1
    return {"entries": n, "bytes": size, "tar": tar_path}


def unpack_cache(tar_path: str, cache_dir: str | None = None,
                 overwrite: bool = False) -> dict:
    """Pre-seed a kernel directory from a `pack_cache` tarball.  Existing
    entries are kept (overwrite=False): library names are content-keyed,
    so a collision means the entry is already present.  Returns
    {"extracted", "skipped", "dir"}."""
    import tarfile
    d = cache_dir or current_dir()
    os.makedirs(d, exist_ok=True)
    extracted = skipped = 0
    with tarfile.open(tar_path, "r:*") as tf:
        for m in tf.getmembers():
            if not m.isfile():
                continue
            # refuse path escapes (the tarball may come from elsewhere)
            dest = os.path.realpath(os.path.join(d, m.name))
            if not dest.startswith(os.path.realpath(d) + os.sep):
                raise ValueError(f"unsafe path in cache tar: {m.name!r}")
            if os.path.exists(dest) and not overwrite:
                skipped += 1
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            # write under a temporary name and rename, as the build does:
            # a process loading from `d` sees no library or a whole one
            tmp = f"{dest}.{os.getpid()}.part"
            with open(tmp, "wb") as out:
                out.write(tf.extractfile(m).read())
            os.replace(tmp, dest)
            extracted += 1
    return {"extracted": extracted, "skipped": skipped, "dir": d}


def cache_stats(cache_dir: str | None = None) -> dict:
    """Entry count and total bytes of a kernel directory (for `info` and
    deployment priming checks)."""
    d = cache_dir or current_dir()
    n = size = 0
    if os.path.isdir(d):
        for root, _, files in os.walk(d):
            for f in files:
                try:
                    size += os.path.getsize(os.path.join(root, f))
                    n += 1
                except OSError:
                    pass
    return {"dir": d, "entries": n, "bytes": size}
