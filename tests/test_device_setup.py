"""Start-up rules that decide where the program runs and what it loads:
the compile-cache placement, device-memory batch sizing, and the keyed
native library."""

import os
import subprocess
import sys

import pytest

import metabuli_tpu
from metabuli_tpu import native
from metabuli_tpu.classify.classifier import (CPU_MEMORY_BYTES,
                                              auto_batch_reads,
                                              device_memory_bytes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ compile cache
def _cache_dir_in_subprocess(env_cache: str | None) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_cache
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, metabuli_tpu; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(metabuli_tpu.compile_cache_dir())"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
        timeout=120)
    used, reported = out.stdout.split()
    assert used == reported
    return used


def test_cache_dir_honours_jax_compilation_cache_dir(tmp_path):
    assert _cache_dir_in_subprocess(str(tmp_path / "cc")) == str(
        tmp_path / "cc")


def test_cache_dir_defaults_to_fixed_path_in_checkout():
    first = _cache_dir_in_subprocess(None)
    assert first == os.path.join(REPO, ".jax_cache")
    # no pid, time or temporary name in it: a second process agrees
    assert _cache_dir_in_subprocess(None) == first


def test_cache_dir_function_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert metabuli_tpu.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert metabuli_tpu.compile_cache_dir() == os.path.join(
        REPO, ".jax_cache")


# ------------------------------------------------------- batch from memory
class FakeDevice:
    def __init__(self, platform, kind, stats):
        self.platform, self.device_kind, self._stats = platform, kind, stats

    def memory_stats(self):
        return self._stats


H100 = FakeDevice("gpu", "NVIDIA H100 80GB HBM3",
                  {"bytes_limit": 60 << 30, "bytes_in_use": 0})
SMALL_GPU = FakeDevice("gpu", "small card", {"bytes_limit": 3 << 30})


@pytest.mark.parametrize("dev, want", [
    (H100, 60 << 30),
    (SMALL_GPU, 3 << 30),
    (FakeDevice("cpu", "cpu", None), CPU_MEMORY_BYTES),
    (FakeDevice("cpu", "cpu", {}), CPU_MEMORY_BYTES),
])
def test_device_memory_bytes(dev, want):
    assert device_memory_bytes(dev) == want


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_device_memory_unknown_platform_without_limit_raises(stats):
    dev = FakeDevice("newaccel", "some accelerator", stats)
    with pytest.raises(RuntimeError, match="--batch-reads"):
        device_memory_bytes(dev)
    with pytest.raises(RuntimeError):
        auto_batch_reads(dev, 1000, True)


def test_auto_batch_reads_from_gpu_memory_stats():
    # 60 GB free after a 60M-row index: the 16k cap binds
    assert auto_batch_reads(H100, 60_000_000, True) == 16384
    assert auto_batch_reads(H100, 60_000_000, False) == 16384
    # a card the index nearly fills plans small batches; fused needs more
    small_fused = auto_batch_reads(SMALL_GPU, 50_000_000, True)
    small_plain = auto_batch_reads(SMALL_GPU, 50_000_000, False)
    assert 512 <= small_fused < small_plain < 16384


def test_auto_batch_reads_cpu_default():
    cpu = FakeDevice("cpu", "cpu", None)
    # 4 GiB default, tiny index: (4 GiB - 1 GiB) / 2 over 300 KB/read
    assert auto_batch_reads(cpu, 1000, True) == 4096
    assert auto_batch_reads(cpu, 1000, False) == 8192


# ---------------------------------------------------------- native library
def test_native_library_key_covers_host_and_flags(monkeypatch):
    base = native.library_path()
    assert os.path.basename(base).startswith("libmetabuli_native-")
    assert native.library_path("address") != base
    monkeypatch.setattr(native, "host_key", lambda: "other-machine:flags")
    assert native.library_path() != base


def test_native_library_key_covers_sources(monkeypatch, tmp_path):
    src = tmp_path / "extra.cpp"
    src.write_text("int x;\n")
    base = native.library_path()
    monkeypatch.setattr(native, "_SRCS", [*native._SRCS, str(src)])
    with_extra = native.library_path()
    src.write_text("int y;\n")
    assert len({base, with_extra, native.library_path()}) == 3


def _fake_compiler(calls):
    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("built")
        return subprocess.CompletedProcess(cmd, 0)
    return run


def test_native_library_built_elsewhere_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.delenv("METABULI_TPU_SANITIZE", raising=False)
    calls = []
    monkeypatch.setattr(native.subprocess, "run", _fake_compiler(calls))
    # a library another host built sits in the directory
    monkeypatch.setattr(native, "host_key", lambda: "host-a:avx512f")
    foreign = native.library_path()
    with open(foreign, "w") as fh:
        fh.write("foreign")
    monkeypatch.setattr(native, "host_key", lambda: "host-b:avx2")
    got = native._build()
    assert got != foreign and len(calls) == 1
    assert open(got).read() == "built"
    assert open(foreign).read() == "foreign"
    # same key again: loaded as is, no second compile
    assert native._build() == got and len(calls) == 1
