"""The kernel-op layer the port's CUDA kernels share (ops/kernel.py), on
the CPU: each op's ctypes argument kinds against its C entry in csrc/,
the tensor check, the build rule and its failures with nvcc replaced by
a fake, the load and the launch with the library and the CUDA stream
replaced by fakes, and the launch count's process-lifetime total
(utils/spans.total). The kernels themselves run only on the card
(tests/test_torch_{contact,aba_kernel,fk_kernel,lstm_kernel}.py, marked
`cuda`)."""

import contextlib
import ctypes
import os
import re
import subprocess
import types

import pytest
import torch

from dwbc_tpu_torch.ops import (aba_kernel, contact_kernel, fk_kernel, kernel,
                                lstm_kernel)
from dwbc_tpu_torch.utils import spans

KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def c_entry_kinds(k):
    """The kinds of the C entry's parameters, read from its source."""
    src = open(k.source).read()
    m = re.search(rf"\bint\s+{k.entry}\s*\(([^)]*)\)", src)
    assert m, f"{k.entry} not in {k.source}"
    kinds = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            kinds.append("pointer")
        else:
            kinds.append(decl.split()[-2])
    return kinds


@pytest.mark.parametrize("mod, k", [
    (contact_kernel, contact_kernel.KERNEL), (aba_kernel, aba_kernel.KERNEL),
    (fk_kernel, fk_kernel.KERNEL), (lstm_kernel, lstm_kernel.FORWARD),
    (lstm_kernel, lstm_kernel.BACKWARD)],
    ids=["contact", "aba", "fk", "lstm", "lstm_backward"])
def test_argtypes_agree_with_the_c_entry(mod, k):
    assert [KINDS[t] for t in k.argtypes] == c_entry_kinds(k)
    # the module's build is its first kernel's, and every kernel of the
    # module is built into that one library with the same flags
    first = getattr(mod, "KERNEL", None) or mod.FORWARD
    assert mod.build == first.build
    assert (k.library, k.flags) == (first.library, first.flags)
    assert os.path.dirname(k.library) == kernel.BUILD


@pytest.mark.parametrize("fault, error, message", [
    ("device", ValueError, "t: on cpu, expected meta"),
    ("dtype", TypeError, "t: dtype torch.float32, expected torch.int32"),
    ("shape", ValueError, r"t: shape \(3, 4\), expected \(4, 3\)")])
def test_check_refuses_a_wrong_tensor(fault, error, message):
    cpu = torch.device("cpu")
    t = torch.zeros(3, 4)
    kernel.check("t", t, (3, 4), cpu)
    device = torch.device("meta") if fault == "device" else cpu
    dtype = torch.int32 if fault == "dtype" else torch.float32
    shape = (4, 3) if fault == "shape" else (3, 4)
    with pytest.raises(error, match=message):
        kernel.check("t", t, shape, device, dtype)


@pytest.fixture
def scratch_kernel(tmp_path, monkeypatch):
    """A Kernel whose source and library live under tmp_path, with nvcc
    replaced by a fake that writes its output file; returns (kernel,
    the fake's calls, a setter of the fake's return code)."""
    k = kernel.Kernel("test_kernel", "test.cu", "dwbc_test",
                      [ctypes.c_void_p])
    k.source = str(tmp_path / "test.cu")
    k.library = str(tmp_path / "build" / "libtest.so")
    with open(k.source, "w") as f:
        f.write("// source\n")
    calls, rc = [], [0]

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("built" if rc[0] == 0 else "partial")
        return subprocess.CompletedProcess(cmd, rc[0], "ptxas info\n", "")

    monkeypatch.setattr(kernel, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel.subprocess, "run", fake_run)
    return k, calls, lambda code: rc.__setitem__(0, code)


@pytest.mark.parametrize("library, force, rebuilt", [
    ("missing", False, True), ("older", False, True),
    ("newer", True, True), ("newer", False, False)],
    ids=["missing", "older", "forced", "up_to_date"])
def test_build_rule(scratch_kernel, library, force, rebuilt):
    k, calls, _ = scratch_kernel
    if library != "missing":
        os.makedirs(os.path.dirname(k.library))
        with open(k.library, "w") as f:
            f.write("old")
        t = os.path.getmtime(k.source)
        os.utime(k.library, (t - 10, t - 10) if library == "older"
                 else (t + 10, t + 10))
    out = k.build(force=force)
    assert len(calls) == int(rebuilt)
    assert out == ("ptxas info\n" if rebuilt else "")
    assert open(k.library).read() == ("built" if rebuilt else "old")
    if rebuilt:
        cmd = calls[0]
        assert cmd[0] == "nvcc" and cmd[-1] == k.source
        assert cmd[1:len(k.flags) + 1] == k.flags
    assert os.listdir(os.path.dirname(k.library)) == ["libtest.so"]


def test_failed_build_raises_and_leaves_no_library(scratch_kernel):
    k, calls, set_rc = scratch_kernel
    set_rc(2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k.build()
    assert len(calls) == 1
    assert os.listdir(os.path.dirname(k.library)) == []


def test_build_without_nvcc_raises(scratch_kernel, monkeypatch, tmp_path):
    k, _, _ = scratch_kernel
    monkeypatch.undo()
    monkeypatch.setattr(kernel.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k.build()
    assert os.listdir(os.path.dirname(k.library)) == []


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's device context and current stream replaced by fakes,
    so that Kernel.launch runs on the CPU."""
    monkeypatch.setattr(kernel.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernel.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))


@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_the_stream_raises_and_counts(fake_card, err):
    k = kernel.Kernel("test_launch_kernel", "test.cu", "dwbc_test",
                      [ctypes.c_void_p, ctypes.c_int])
    calls = []
    k._fn = lambda *args: calls.append(args) or err
    before = spans.total(k.name)
    if err:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            k.launch(torch.device("cpu"), 11, 3)
    else:
        k.launch(torch.device("cpu"), 11, 3)
    assert calls == [(11, 3, 7)]
    assert spans.total(k.name) - before == (0 if err else 1)


def test_load_opens_the_library_once_inside_setup_native(fake_card,
                                                         monkeypatch):
    k = kernel.Kernel("test_load_kernel", "test.cu", "dwbc_test",
                      [ctypes.c_int])
    built, opened = [], []

    class FakeEntry:
        def __call__(self, *args):
            return 0

    def fake_cdll(path):
        opened.append(path)
        return types.SimpleNamespace(dwbc_test=FakeEntry())

    monkeypatch.setattr(k, "build", lambda force=False: built.append(force))
    monkeypatch.setattr(kernel.ctypes, "CDLL", fake_cdll)
    setup = spans.setup_record()["spans"].get("setup.native", [0, 0])[0]
    for _ in range(2):
        k.launch(torch.device("cpu"), 1)
    assert opened == [k.library] and built == [False]
    assert k._fn.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert k._fn.restype is ctypes.c_int
    assert spans.setup_record()["spans"]["setup.native"][0] == setup + 1


def test_a_count_outside_an_iteration_reaches_only_the_total():
    spans.reset()
    before = spans.total("test_counter")
    spans.begin_iteration(0)
    spans.count("test_counter")
    spans.end_iteration()
    spans.count("test_counter", 2)
    assert spans.total("test_counter") - before == 3
    assert [r["counters"] for r in spans.records()] == [{"test_counter": 1}]
    spans.reset()
    assert spans.total("test_counter") - before == 3
    assert spans.records() == []
