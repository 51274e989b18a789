"""The CUDA sources' plane layouts and protocol constants match Python.

The kernels index the packed stacks by ``enum`` field indices and compare
against hard-coded protocol codes; neither can be compiled here, so this
test parses the enums out of ``src/repro_torch/csrc/*.cu`` and holds them
against the ``_fields`` order of the six plane sets and the values of the
protocol enums.
"""

import ctypes
import pathlib
import re

import pytest
import torch

from repro_torch.core import proposer_vector, vector
from repro_torch.core.proposer import ABD_PAUSED, AbdPhase, Decision, Phase
from repro_torch.core.types import KVState, MsgKind, Rep
from repro_torch.kernels import _build
from repro_torch.kernels.paxos_propose import ops as propose_ops
from torch_threads import one_thread  # noqa: F401 (autouse)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "csrc"

_ENUM = re.compile(r"\benum\s+(\w+)\s*\{(.*?)\}", re.S)


def _enums():
    """``{(file stem, enum name): [(member, value or None), ...]}``."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, body in _ENUM.findall(text):
            members = []
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                if "=" in item:
                    k, v = (s.strip() for s in item.split("=", 1))
                    members.append((k, int(v)))
                else:
                    members.append((item, None))
            out[(path.stem, name)] = members
    return out


ENUMS = _enums()

FIELD_SETS = [
    ("paxos_apply", "KVTable", "KV_", vector.KVTable._fields),
    ("paxos_apply", "MsgBatch", "MSG_", vector.MsgBatch._fields),
    ("paxos_apply", "ReplyBatch", "RPL_", vector.ReplyBatch._fields),
    ("paxos_propose", "ProposerTable", "TAB_",
     proposer_vector.ProposerTable._fields),
    ("paxos_propose", "IssuerReplyBatch", "IRP_",
     proposer_vector.IssuerReplyBatch._fields),
    ("paxos_propose", "ActionBatch", "ACT_",
     proposer_vector.ActionBatch._fields),
    ("paxos_propose", "ChangedPlane", "CHG_", propose_ops.CHANGED_FIELDS),
]


@pytest.mark.parametrize("stem,enum,prefix,fields", FIELD_SETS,
                         ids=[f"{s}:{e}" for s, e, _, _ in FIELD_SETS])
def test_plane_enum_matches_fields(stem, enum, prefix, fields):
    members = ENUMS[(stem, enum)]
    assert all(v is None for _, v in members), "field enums count from 0"
    assert [m for m, _ in members] == [prefix + f for f in fields]


def _codes(enum_cls, prefix):
    return {prefix + m.name: int(m.value) for m in enum_cls}


LANE_KINDS = {"LK_NOOP": vector.NOOP, "LK_PROPOSE": vector.PROPOSE,
              "LK_ACCEPT": vector.ACCEPT, "LK_COMMIT": vector.COMMIT,
              "LK_WRITE_QUERY": vector.WRITE_QUERY, "LK_WRITE": vector.WRITE,
              "LK_READ_QUERY": vector.READ_QUERY,
              "LK_READ_COMMIT": vector.READ_COMMIT}

CODE_SETS = [
    ("paxos_apply", "LaneKind", LANE_KINDS),
    ("paxos_apply", "KVState", _codes(KVState, "KVS_")),
    ("paxos_apply", "Rep", _codes(Rep, "REP_")),
    ("paxos_apply", "MsgKind", _codes(MsgKind, "MK_")),
    ("paxos_propose", "Rep", _codes(Rep, "REP_")),
    ("paxos_propose", "MsgKind", _codes(MsgKind, "MK_")),
    ("paxos_propose", "Phase", _codes(Phase, "PH_")),
    ("paxos_propose", "AbdPhase",
     {**_codes(AbdPhase, "AP_"), "AP_PAUSED": ABD_PAUSED}),
    ("paxos_propose", "Decision", _codes(Decision, "D_")),
]


@pytest.mark.parametrize("stem,enum,expected", CODE_SETS,
                         ids=[f"{s}:{e}" for s, e, _ in CODE_SETS])
def test_protocol_codes_match_python(stem, enum, expected):
    members = dict(ENUMS[(stem, enum)])
    assert members, f"{stem}.cu has no enum {enum}"
    for name, value in members.items():
        assert name in expected, f"{stem}.cu {enum}: unknown {name}"
        assert value == expected[name], f"{stem}.cu {enum}.{name}"


@pytest.mark.parametrize("table,fields", [
    ("kPassThrough", propose_ops.PASS_THROUGH_FIELDS),
    ("kChanged", propose_ops.CHANGED_FIELDS)])
def test_propose_plane_tables_match_python(table, fields):
    """paxos_propose.cu's pass-through and changed-plane tables name the
    planes the wrappers split the table into, in the same order."""
    text = re.sub(r"//[^\n]*", "", (CSRC / "paxos_propose.cu").read_text())
    body = re.search(table + r"\[\]\s*=\s*\{(.*?)\}", text, re.S).group(1)
    assert [m.strip() for m in body.split(",") if m.strip()] == \
        ["TAB_" + f for f in fields]


def test_reply_kind_table_matches_python():
    """paxos_apply.cu maps each lane kind to its reply MsgKind in a switch;
    every arm must agree with vector.REPLY_KIND."""
    text = (CSRC / "paxos_apply.cu").read_text()
    arms = dict(re.findall(r"case (LK_\w+): rep_kind = (MK_\w+);", text))
    want = {name: "MK_" + vector.REPLY_KIND[code].name
            for name, code in LANE_KINDS.items() if code != vector.NOOP}
    assert arms == want


# ---------------------------------------------------------------------------
# C entry points and element-type codes of the float kernels
# ---------------------------------------------------------------------------

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\((.*?)\)\s*\{', re.S)


def _c_entry_points():
    """``{name: [argument types as 'ptr' / 'i64' / 'f32']}`` of every
    ``extern "C"`` function in ``csrc/*.cu``."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, args in _EXTERN.findall(text):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append("ptr")
                elif arg.startswith("int64_t"):
                    kinds.append("i64")
                elif arg.startswith("float"):
                    kinds.append("f32")
                else:
                    kinds.append(arg)
            out[name] = kinds
    return out


C_ENTRY_POINTS = _c_entry_points()
_CTYPE_KIND = {ctypes.c_void_p: "ptr", ctypes.c_int64: "i64",
               ctypes.c_float: "f32"}


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_signature_matches_build(name):
    assert name in C_ENTRY_POINTS, f"no extern \"C\" {name} in csrc/"
    want = [_CTYPE_KIND[t] for t in _build.ENTRY_POINTS[name]]
    assert C_ENTRY_POINTS[name] == want


def test_every_c_entry_point_is_bound():
    assert set(C_ENTRY_POINTS) == set(_build.ENTRY_POINTS)


@pytest.mark.parametrize("stem",
                         ["flash_attention", "mamba2_ssd", "rwkv6_wkv"])
def test_dtype_codes_match_the_wrappers(stem):
    members = dict(ENUMS[(stem, "DType")])
    assert members == {"DT_F32": _build.dtype_code(torch.float32),
                       "DT_BF16": _build.dtype_code(torch.bfloat16)}
    assert _build.dtype_code(torch.float16) is None
    ops_src = (CSRC.parent / "kernels" / stem / "ops.py").read_text()
    assert "_build.dtype_code(" in ops_src


# ---------------------------------------------------------------------------
# the build's cache key
# ---------------------------------------------------------------------------

def test_library_path_follows_sources_headers_and_flags(tmp_path,
                                                        monkeypatch):
    """An edit to a source, a shared header or the flags names another
    library, so a stale one is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert _build.library_path() == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path()
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = _build.library_path()
    assert third not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-I/usr/local/cutlass/include",))
    assert _build.library_path() not in (first, second, third)


def test_local_includes_are_hashed_headers():
    """Every ``#include "..."`` of a source names a header of csrc/ that
    the cache key covers."""
    hashed = {p.name for p in _build.headers()}
    for path in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r'#include\s+"([^"]+)"', path.read_text()):
            assert name in hashed, f"{path.name} includes {name}"
