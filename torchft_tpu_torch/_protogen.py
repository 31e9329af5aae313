"""Generates protobuf-free C++ message classes from a proto3 schema.

The native coordination plane (``native/src``) speaks protobuf through
``#include "tpuft.pb.h"`` and nothing else: it calls ``set_*``,
``mutable_*``, ``add_*``, ``has_*``, ranges over repeated fields,
``SerializeAsString``, ``ParseFromString``/``ParseFromArray`` and
``ByteSizeLong``, and never names a ``google::protobuf`` type. This module
reads ``native/proto/tpuft.proto`` and writes a ``tpuft.pb.h`` and
``tpuft.pb.cc`` that give that API over the wire helpers in
``csrc/native_pb/pb_wire.h``, so the plane builds with g++ alone on a
machine that has no protobuf C++ library, headers or ``protoc``.

It takes the subset of proto3 the schema uses: top-level messages with
scalar, string, bytes and message fields, and ``optional`` and
``repeated`` labels. Anything else (enums, nested types, maps, oneofs,
groups, the sint/fixed types) raises. The bytes it writes follow proto3 as
protobuf's own runtimes do: fields in number order, default scalars not
written unless the field is ``optional``, negative int32/int64 values as
10-byte varints, repeated numbers packed; parsing skips unknown fields and
accepts packed and unpacked repeated numbers.

    python -m torchft_tpu_torch._protogen native/proto/tpuft.proto OUT_DIR
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["Field", "Message", "Schema", "parse_proto", "generate"]

# proto type -> (C++ type, wire type, kind)
_SCALARS = {
    "double": ("double", "kFixed64", "double"),
    "float": ("float", "kFixed32", "float"),
    "int64": ("int64_t", "kVarint", "signed"),
    "int32": ("int32_t", "kVarint", "signed"),
    "uint64": ("uint64_t", "kVarint", "unsigned"),
    "uint32": ("uint32_t", "kVarint", "unsigned"),
    "bool": ("bool", "kVarint", "bool"),
    "string": ("std::string", "kLengthDelimited", "bytes"),
    "bytes": ("std::string", "kLengthDelimited", "bytes"),
}
_CPP_KEYWORDS = {
    "auto", "bool", "break", "case", "catch", "char", "class", "const", "continue",
    "default", "delete", "do", "double", "else", "enum", "explicit", "extern", "false",
    "float", "for", "friend", "goto", "if", "inline", "int", "long", "namespace", "new",
    "operator", "private", "protected", "public", "register", "return", "short",
    "signed", "sizeof", "static", "struct", "switch", "template", "this", "throw",
    "true", "try", "typedef", "union", "unsigned", "using", "virtual", "void",
    "volatile", "while",
}


@dataclass
class Field:
    name: str
    type: str  # a scalar name or a message name
    number: int
    label: str  # "", "optional" or "repeated"


@dataclass
class Message:
    name: str
    fields: List[Field] = field(default_factory=list)


@dataclass
class Schema:
    package: str
    messages: List[Message]


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


_FIELD = re.compile(
    r"^(?:(optional|repeated)\s+)?([A-Za-z_][\w.]*)\s+([A-Za-z_]\w*)\s*=\s*(\d+)\s*(\[[^\]]*\])?$"
)


def parse_proto(text: str) -> Schema:
    """Parses the supported proto3 subset; raises ``ValueError`` on the rest."""
    text = _strip_comments(text)
    if not re.search(r'syntax\s*=\s*"proto3"\s*;', text):
        raise ValueError("only proto3 schemas are supported")
    package = re.search(r"package\s+([\w.]+)\s*;", text)
    if package is None or "." in package.group(1):
        raise ValueError("the schema needs a one-word package")
    body = re.sub(r'syntax\s*=\s*"proto3"\s*;|package\s+[\w.]+\s*;', " ", text)
    messages: List[Message] = []
    pos = 0
    block = re.compile(r"\s*message\s+([A-Za-z_]\w*)\s*\{([^{}]*)\}", re.S)
    while pos < len(body):
        if not body[pos:].strip():
            break
        match = block.match(body, pos)
        if match is None:
            raise ValueError(f"unsupported construct near: {body[pos:pos + 80].strip()!r}")
        name, inner = match.groups()
        message = Message(name)
        for statement in (s.strip() for s in inner.split(";")):
            if not statement:
                continue
            parsed = _FIELD.match(statement)
            if parsed is None:
                raise ValueError(f"message {name}: unsupported statement {statement!r}")
            label, ftype, fname, number, _ = parsed.groups()
            if fname in _CPP_KEYWORDS:
                raise ValueError(f"message {name}: field {fname!r} is a C++ keyword")
            message.fields.append(Field(fname, ftype, int(number), label or ""))
        messages.append(message)
        pos = match.end()
    names = {m.name for m in messages}
    for message in messages:
        for f in message.fields:
            if f.type not in _SCALARS and f.type not in names:
                raise ValueError(f"{message.name}.{f.name}: unsupported type {f.type!r}")
            if f.label == "optional" and f.type in names:
                raise ValueError(f"{message.name}.{f.name}: optional message fields are not supported")
        numbers = [f.number for f in message.fields]
        if len(set(numbers)) != len(numbers):
            raise ValueError(f"{message.name}: duplicate field numbers")
        message.fields.sort(key=lambda f: f.number)
    return Schema(package.group(1), _dependency_order(messages))


def _dependency_order(messages: List[Message]) -> List[Message]:
    """Messages ordered so each comes after those it holds by value."""
    by_name = {m.name: m for m in messages}
    done: List[Message] = []
    state: Dict[str, int] = {}

    def visit(message: Message) -> None:
        if state.get(message.name) == 2:
            return
        if state.get(message.name) == 1:
            raise ValueError(f"recursive message {message.name} is not supported")
        state[message.name] = 1
        for f in message.fields:
            if f.type in by_name:
                visit(by_name[f.type])
        state[message.name] = 2
        done.append(message)

    for message in messages:
        visit(message)
    return done


# ---------------------------------------------------------------------------
# C++ emission
# ---------------------------------------------------------------------------


def _kind(schema: Schema, f: Field) -> str:
    return _SCALARS[f.type][2] if f.type in _SCALARS else "message"


def _cpp_type(schema: Schema, f: Field) -> str:
    return _SCALARS[f.type][0] if f.type in _SCALARS else f.type


def _wire(schema: Schema, f: Field) -> str:
    return _SCALARS[f.type][1] if f.type in _SCALARS else "kLengthDelimited"


def _accessors(schema: Schema, f: Field) -> List[str]:
    n, t, kind = f.name, _cpp_type(schema, f), _kind(schema, f)
    if f.label == "repeated":
        lines = [
            f"  const std::vector<{t}>& {n}() const {{ return {n}_; }}",
            f"  std::vector<{t}>* mutable_{n}() {{ return &{n}_; }}",
            f"  int {n}_size() const {{ return static_cast<int>({n}_.size()); }}",
            f"  void clear_{n}() {{ {n}_.clear(); }}",
        ]
        if kind in ("message", "bytes"):
            lines.append(f"  const {t}& {n}(int i) const {{ return {n}_[i]; }}")
        else:
            lines.append(f"  {t} {n}(int i) const {{ return {n}_[i]; }}")
        if kind in ("message", "bytes"):
            lines += [
                f"  {t}* mutable_{n}(int i) {{ return &{n}_[i]; }}",
                f"  {t}* add_{n}() {{ {n}_.emplace_back(); return &{n}_.back(); }}",
            ]
        if kind != "message":
            lines += [
                f"  void set_{n}(int i, {t} v) {{ {n}_[i] = std::move(v); }}",
                f"  void add_{n}({t} v) {{ {n}_.push_back(std::move(v)); }}",
            ]
        return lines
    if kind == "message":
        return [
            f"  const {t}& {n}() const {{ return {n}_; }}",
            f"  {t}* mutable_{n}() {{ has_{n}_ = true; return &{n}_; }}",
            f"  bool has_{n}() const {{ return has_{n}_; }}",
            f"  void clear_{n}() {{ {n}_ = {t}(); has_{n}_ = false; }}",
        ]
    mark = f" has_{n}_ = true;" if f.label == "optional" else ""
    unmark = f" has_{n}_ = false;" if f.label == "optional" else ""
    if kind == "bytes":
        lines = [
            f"  const std::string& {n}() const {{ return {n}_; }}",
            f"  void set_{n}(const std::string& v) {{ {n}_ = v;{mark} }}",
            f"  void set_{n}(std::string&& v) {{ {n}_ = std::move(v);{mark} }}",
            f"  void set_{n}(const char* v) {{ {n}_ = v;{mark} }}",
            f"  void set_{n}(const void* v, size_t size) {{ {n}_.assign(static_cast<const char*>(v), size);{mark} }}",
            f"  std::string* mutable_{n}() {{{mark} return &{n}_; }}",
            f"  void clear_{n}() {{ {n}_.clear();{unmark} }}",
        ]
    else:
        lines = [
            f"  {t} {n}() const {{ return {n}_; }}",
            f"  void set_{n}({t} v) {{ {n}_ = v;{mark} }}",
            f"  void clear_{n}() {{ {n}_ = {t}();{unmark} }}",
        ]
    if f.label == "optional":
        lines.append(f"  bool has_{n}() const {{ return has_{n}_; }}")
    return lines


def _members(schema: Schema, f: Field) -> List[str]:
    n, t = f.name, _cpp_type(schema, f)
    if f.label == "repeated":
        return [f"  std::vector<{t}> {n}_;"]
    lines = [f"  {t} {n}_{{}};"]
    if f.label == "optional" or _kind(schema, f) == "message":
        lines.append(f"  bool has_{n}_ = false;")
    return lines


def _put_value(kind: str, out: str, expr: str) -> str:
    """Statement appending one value's bytes (no tag)."""
    if kind == "signed":
        return f"tpuft_pb::put_varint({out}, static_cast<uint64_t>(static_cast<int64_t>({expr})));"
    if kind in ("unsigned", "bool"):
        return f"tpuft_pb::put_varint({out}, static_cast<uint64_t>({expr}));"
    if kind == "double":
        return f"tpuft_pb::put_fixed64({out}, tpuft_pb::double_bits({expr}));"
    if kind == "float":
        return f"tpuft_pb::put_fixed32({out}, tpuft_pb::float_bits({expr}));"
    raise AssertionError(kind)


def _serialize(schema: Schema, f: Field) -> List[str]:
    n, num, kind = f.name, f.number, _kind(schema, f)
    wire = _wire(schema, f)
    if kind == "message":
        body = [
            "    std::string sub;",
            "    {x}.AppendTo(&sub);",
            f"    tpuft_pb::put_bytes(out, {num}, sub);",
        ]
        if f.label == "repeated":
            return [f"  for (const auto& x : {n}_) {{"] + [
                line.format(x="x") for line in body] + ["  }"]
        return [f"  if (has_{n}_) {{"] + [line.format(x=f"{n}_") for line in body] + ["  }"]
    if kind == "bytes":
        if f.label == "repeated":
            return [f"  for (const auto& x : {n}_) tpuft_pb::put_bytes(out, {num}, x);"]
        cond = f"has_{n}_" if f.label == "optional" else f"!{n}_.empty()"
        return [f"  if ({cond}) tpuft_pb::put_bytes(out, {num}, {n}_);"]
    if f.label == "repeated":
        return [
            f"  if (!{n}_.empty()) {{",
            "    std::string packed;",
            f"    for (const auto& x : {n}_) {_put_value(kind, '&packed', 'x')}",
            f"    tpuft_pb::put_bytes(out, {num}, packed);",
            "  }",
        ]
    if f.label == "optional":
        cond = f"has_{n}_"
    elif kind == "double":
        cond = f"tpuft_pb::double_bits({n}_) != 0"
    elif kind == "float":
        cond = f"tpuft_pb::float_bits({n}_) != 0"
    else:
        cond = f"{n}_ != {_cpp_type(schema, f)}()"
    return [
        f"  if ({cond}) {{",
        f"    tpuft_pb::put_tag(out, {num}, tpuft_pb::{wire});",
        f"    {_put_value(kind, 'out', n + '_')}",
        "  }",
    ]


def _read_value(schema: Schema, f: Field, reader: str, target: str) -> List[str]:
    """Statements reading one value from ``reader`` into ``target``
    (an lvalue expression); return false on malformed input."""
    kind, t = _kind(schema, f), _cpp_type(schema, f)
    if kind == "double":
        return [f"{{ uint64_t v; if (!{reader}.fixed64(&v)) return false; {target} = tpuft_pb::bits_double(v); }}"]
    if kind == "float":
        return [f"{{ uint32_t v; if (!{reader}.fixed32(&v)) return false; {target} = tpuft_pb::bits_float(v); }}"]
    if kind == "bool":
        return [f"{{ uint64_t v; if (!{reader}.varint(&v)) return false; {target} = v != 0; }}"]
    return [f"{{ uint64_t v; if (!{reader}.varint(&v)) return false; {target} = static_cast<{t}>(v); }}"]


def _parse_case(schema: Schema, f: Field) -> List[str]:
    n, kind, wire = f.name, _kind(schema, f), _wire(schema, f)
    lines = [f"      case {f.number}:"]
    if kind == "message":
        target = f"{n}_.back()" if f.label == "repeated" else f"{n}_"
        prep = f"{n}_.emplace_back(); " if f.label == "repeated" else f"has_{n}_ = true; "
        lines += [
            f"        if (type == tpuft_pb::{wire}) {{",
            "          tpuft_pb::Reader sub{nullptr, nullptr};",
            f"          if (!r.sub(&sub)) return false;",
            f"          {prep}if (!{target}.MergeFrom(sub)) return false;",
            "          continue;",
            "        }",
            "        break;",
        ]
        return lines
    if kind == "bytes":
        if f.label == "repeated":
            read = f"{n}_.emplace_back(); if (!r.bytes(&{n}_.back())) return false;"
        else:
            mark = f" has_{n}_ = true;" if f.label == "optional" else ""
            read = f"if (!r.bytes(&{n}_)) return false;{mark}"
        return lines + [
            f"        if (type == tpuft_pb::{wire}) {{ {read} continue; }}",
            "        break;",
        ]
    if f.label == "repeated":
        t = _cpp_type(schema, f)
        one = _read_value(schema, f, "r", "x")[0]
        packed = _read_value(schema, f, "packed", "x")[0]
        return lines + [
            f"        if (type == tpuft_pb::{wire}) {{ {t} x{{}}; {one} {n}_.push_back(x); continue; }}",
            "        if (type == tpuft_pb::kLengthDelimited) {",
            "          tpuft_pb::Reader packed{nullptr, nullptr};",
            "          if (!r.sub(&packed)) return false;",
            f"          while (!packed.done()) {{ {t} x{{}}; {packed} {n}_.push_back(x); }}",
            "          continue;",
            "        }",
            "        break;",
        ]
    mark = f" has_{n}_ = true;" if f.label == "optional" else ""
    read = _read_value(schema, f, "r", f"{n}_")[0]
    return lines + [
        f"        if (type == tpuft_pb::{wire}) {{ {read}{mark} continue; }}",
        "        break;",
    ]


def generate(schema: Schema) -> Dict[str, str]:
    """Returns ``{"tpuft.pb.h": ..., "tpuft.pb.cc": ...}``."""
    ns = schema.package
    header = [
        "// Generated by torchft_tpu_torch/_protogen.py from tpuft.proto. Do not edit.",
        "#pragma once",
        "",
        "#include <cstddef>",
        "#include <cstdint>",
        "#include <string>",
        "#include <vector>",
        "",
        '#include "pb_wire.h"',
        "",
        f"namespace {ns} {{",
        "",
    ]
    source = [
        "// Generated by torchft_tpu_torch/_protogen.py from tpuft.proto. Do not edit.",
        '#include "tpuft.pb.h"',
        "",
        "#include <cstring>",
        "",
        f"namespace {ns} {{",
        "",
    ]
    for message in schema.messages:
        m = message.name
        header += [
            f"class {m} {{",
            " public:",
        ]
        for f in message.fields:
            header += _accessors(schema, f)
        header += [
            f"  void Clear() {{ *this = {m}(); }}",
            f"  void CopyFrom(const {m}& other) {{ *this = other; }}",
            "  std::string SerializeAsString() const { std::string out; AppendTo(&out); return out; }",
            "  bool SerializeToString(std::string* out) const { out->clear(); AppendTo(out); return true; }",
            "  bool SerializeToArray(void* data, int size) const;",
            "  size_t ByteSizeLong() const { return SerializeAsString().size(); }",
            "  bool ParseFromString(const std::string& bytes) { return ParseFromArray(bytes.data(), static_cast<int>(bytes.size())); }",
            "  bool ParseFromArray(const void* data, int size);",
            "  // Appends this message's bytes; merges parsed fields into this one.",
            "  void AppendTo(std::string* out) const;",
            "  bool MergeFrom(tpuft_pb::Reader& r);",
            "",
            " private:",
        ]
        for f in message.fields:
            header += _members(schema, f)
        header += ["};", ""]

        source += [f"void {m}::AppendTo(std::string* out) const {{"]
        if not message.fields:
            source.append("  (void)out;")
        for f in message.fields:
            source += _serialize(schema, f)
        source += ["}", ""]
        source += [
            f"bool {m}::MergeFrom(tpuft_pb::Reader& r) {{",
            "  while (!r.done()) {",
            "    uint64_t tag;",
            "    if (!r.varint(&tag)) return false;",
            "    const uint32_t number = static_cast<uint32_t>(tag >> 3);",
            "    const uint32_t type = static_cast<uint32_t>(tag & 7);",
            "    if (number == 0) return false;",
        ]
        if message.fields:
            source.append("    switch (number) {")
            for f in message.fields:
                source += _parse_case(schema, f)
            source += ["      default:", "        break;", "    }"]
        source += [
            "    if (!r.skip(type)) return false;",
            "  }",
            "  return true;",
            "}",
            "",
            f"bool {m}::ParseFromArray(const void* data, int size) {{",
            "  Clear();",
            "  if (size < 0) return false;",
            "  const auto* p = static_cast<const uint8_t*>(data);",
            "  tpuft_pb::Reader r{p, p + size};",
            "  return MergeFrom(r);",
            "}",
            "",
            f"bool {m}::SerializeToArray(void* data, int size) const {{",
            "  const std::string bytes = SerializeAsString();",
            "  if (size < 0 || bytes.size() > static_cast<size_t>(size)) return false;",
            "  std::memcpy(data, bytes.data(), bytes.size());",
            "  return true;",
            "}",
            "",
        ]
    header += [f"}}  // namespace {ns}", ""]
    # A test entry point: parse bytes as the named message and write them
    # back out, so a test can hold these classes' bytes against
    # google.protobuf's.
    source += [
        "namespace {",
        "template <typename M>",
        "int reserialize(const uint8_t* in, int len, uint8_t* out, int cap) {",
        "  M message;",
        "  if (!message.ParseFromArray(in, len)) return -1;",
        "  const std::string bytes = message.SerializeAsString();",
        "  if (bytes.size() > static_cast<size_t>(cap)) return -3;",
        "  std::memcpy(out, bytes.data(), bytes.size());",
        "  return static_cast<int>(bytes.size());",
        "}",
        "}  // namespace",
        "",
        f"}}  // namespace {ns}",
        "",
        'extern "C" int tpuft_pb_reserialize(const char* type, const uint8_t* in, int len,',
        "                                    uint8_t* out, int cap) {",
    ]
    for message in schema.messages:
        source.append(
            f'  if (std::strcmp(type, "{message.name}") == 0) '
            f"return {ns}::reserialize<{ns}::{message.name}>(in, len, out, cap);"
        )
    source += ["  return -2;", "}", ""]
    return {"tpuft.pb.h": "\n".join(header), "tpuft.pb.cc": "\n".join(source)}


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m torchft_tpu_torch._protogen SCHEMA.proto OUT_DIR")
    out = Path(argv[1])
    out.mkdir(parents=True, exist_ok=True)
    for name, text in generate(parse_proto(Path(argv[0]).read_text())).items():
        (out / name).write_text(text)


if __name__ == "__main__":
    main()
