"""oswald_tpu_torch.utils.compile_cache: where the kernel libraries are
built and loaded from.

The directory resolves as oswald_tpu's compile cache does: the argument,
then the OSWALD_TPU_TORCH_COMPILE_CACHE env var ("0", "", "off", "false",
"no" disable it), then $XDG_CACHE_HOME, then ~/.cache.  Disabled means a
temporary directory of the process, removed at exit.  `kernels.build`
names every library after its sources and flags and puts it in the
directory enabled, never beside the package unless that was enabled.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from oswald_tpu_torch.kernels import build
from oswald_tpu_torch.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]
SUB = os.path.join("oswald-tpu-torch", "kernels")


@pytest.fixture(autouse=True)
def clean_state(tmp_path, monkeypatch):
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.delenv("OSWALD_TPU_TORCH_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)


def test_resolution_order(tmp_path, monkeypatch):
    home = tmp_path / "home"
    assert compile_cache.default_cache_dir() == str(home / ".cache" / SUB)
    assert compile_cache.current_dir() == str(home / ".cache" / SUB)
    assert build.build_dir() == home / ".cache" / SUB
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert compile_cache.enable_compile_cache(quiet=True) == \
        str(tmp_path / "xdg" / SUB)
    monkeypatch.setenv("OSWALD_TPU_TORCH_COMPILE_CACHE", str(tmp_path / "env"))
    assert compile_cache.enable_compile_cache(quiet=True) == \
        str(tmp_path / "env")
    # the argument comes first, even where the env var disables
    assert compile_cache.enable_compile_cache(str(tmp_path / "arg"),
                                              quiet=True) == \
        str(tmp_path / "arg")
    monkeypatch.setenv("OSWALD_TPU_TORCH_COMPILE_CACHE", "off")
    assert compile_cache.enable_compile_cache(str(tmp_path / "arg2"),
                                              quiet=True) == \
        str(tmp_path / "arg2")
    for d in ("xdg/" + SUB, "env", "arg", "arg2"):
        assert (tmp_path / d).is_dir()
    assert not (home / ".cache").exists()


@pytest.mark.parametrize("value", ["0", "", "off", "false", "no", " No "])
def test_env_var_disables(tmp_path, monkeypatch, value):
    monkeypatch.setenv("OSWALD_TPU_TORCH_COMPILE_CACHE", value)
    assert compile_cache.enable_compile_cache(quiet=True) is None
    d = compile_cache.current_dir()
    assert d == compile_cache._temp_dir and os.path.isdir(d)
    assert Path(d).name.startswith("oswald-tpu-torch-kernels-")
    assert build.build_dir() == Path(d)
    # the same process keeps its one temporary directory
    assert compile_cache.disable_compile_cache() == d


def test_unmakeable_directory_disables(tmp_path, capsys):
    (tmp_path / "file").write_text("x")
    assert compile_cache.enable_compile_cache(str(tmp_path / "file" / "d")) \
        is None
    assert "kernel cache disabled" in capsys.readouterr().err
    assert compile_cache.current_dir() == compile_cache._temp_dir


def test_library_path_under_enabled_dir(tmp_path):
    compile_cache.enable_compile_cache(str(tmp_path / "k"), quiet=True)
    for name in build.SIGNATURES:
        path = build.library_path(name)
        assert path.parent == tmp_path / "k"
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert REPO not in path.parents


def test_disabled_temp_dir_removed_at_exit(tmp_path):
    """--no-compile-cache leaves nothing behind, and two processes never
    share a temporary directory."""
    script = ("from oswald_tpu_torch.cli.main import _enable_cache, "
              "build_parser\n"
              "from oswald_tpu_torch.kernels import build\n"
              "args = build_parser().parse_args(['cache', 'info', "
              "'--no-compile-cache'])\n"
              "_enable_cache(args)\n"
              "d = build.build_dir()\n"
              "(d / 'libx.so').write_bytes(b'x')\n"
              "print(d)\n")
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    dirs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        dirs.append(Path(out.stdout.strip()))
    assert dirs[0] != dirs[1]
    assert all(d.parent == tmp_path for d in dirs)
    assert not any(d.exists() for d in dirs)
