"""``accelerate-tpu-torch config``: write and read the launch configuration
file (the port of `accelerate_tpu/commands/config.py`).

The file, its keys and its default path are JAX's (`DEFAULT_CONFIG`;
``$ACCELERATE_TPU_CONFIG_HOME/default_config.yaml``, `env.default_config_file`),
so one file launches either package. The keys the port's launcher cannot
serve (the TPU-pod and cloud keys, sequence parallelism, mesh axes other
than "data" and "fsdp", ``compilation_cache``, ``downcast_bf16``) are kept
in the file and refused at launch (`launch.refuse_unported`).

The card's machine has no PyYAML, so the file is read and written here:
`parse_config` reads the block-style subset that ``yaml.safe_dump(...,
sort_keys=False)`` writes for these keys (scalars, ``null``, booleans,
nested maps and lists of scalars, plain, single- or double-quoted strings,
folded continuation lines), resolving plain scalars as PyYAML does (YAML
1.1: ``yes``/``on`` are booleans, ``1e3`` is a string); `dump_config`
writes a file both readers load to the same dict.

The questionnaire asks JAX's questions in JAX's order, without the first
(the compute environment) and the TPU-pod and cloud questions behind it:
those wait for ROADMAP A item 2's GPU-host launch plan. A non-interactive
stdin answers them line by line, as in JAX.
"""

from __future__ import annotations

import json
import math
import os
import re

from .env import default_config_file

DEFAULT_CONFIG = {
    "compute_environment": "LOCAL_MACHINE",
    "distributed_type": "XLA_SPMD",
    "mixed_precision": "bf16",
    "num_processes": 1,
    "mesh": {"data": -1, "fsdp": 1, "model": 1, "seq": 1, "expert": 1, "stage": 1},
    "gradient_accumulation_steps": 1,
    "coordinator_address": None,
    "tpu_name": None,
    "tpu_zone": None,
    "tpu_use_cluster": False,
    "downcast_bf16": False,
}

MESH_AXES = ("data", "fsdp", "model", "seq", "expert", "stage")


def register_subcommand(subparsers):
    parser = subparsers.add_parser("config", help="Create the launch config file")
    parser.add_argument("--config_file", default=None, help="Path to write the config YAML")
    parser.add_argument("--default", action="store_true", help="Write the default config without prompting")
    parser.set_defaults(func=config_command)
    return parser


# ------------------------------------------------------------------ the file
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
# PyYAML's YAML 1.1 resolver for ints and floats.
_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"""
                  r"""|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"""
                    r"""|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""")
_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+\-=@]*")


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _plain_scalar(text: str):
    """A plain scalar as PyYAML's resolver reads it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        digits = text.replace("_", "")
        body = digits.lstrip("+-")
        sign = -1 if digits[0] == "-" else 1
        if ":" in body:
            return _sexagesimal(digits, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body.startswith("0") and len(body) > 1:
            return sign * int(body, 8)
        return int(digits)
    if _FLOAT.fullmatch(text):
        digits = text.replace("_", "").lower()
        if digits.endswith("inf"):
            return -math.inf if digits[0] == "-" else math.inf
        if digits.endswith("nan"):
            return math.nan
        if ":" in digits:
            return _sexagesimal(digits, float)
        return float(digits)
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _unescape(body: str) -> str:
    """A double-quoted scalar's body with YAML's escapes resolved."""
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        code = body[i + 1]
        if code in _HEX:
            n = _HEX[code]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        else:
            raise ValueError(f"config file: unknown escape \\{code} in {body!r}")
    return "".join(out)


def _quoted(text: str):
    """A single- or double-quoted scalar (``text`` holds its quotes)."""
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    return _unescape(text[1:-1])


def _scalar(text: str):
    if text in ("{}", "[]"):
        return {} if text == "{}" else []
    if text[:1] in ("'", '"'):
        return _quoted(text)
    if text[:1] in ("[", "{", "&", "*", "!", "|", ">"):
        raise ValueError(f"config file: {text!r}: the port reads block-style YAML only (as yaml.safe_dump writes)")
    return _plain_scalar(text)


def _strip_comment(text: str) -> str:
    if text[:1] in ("'", '"'):
        return text
    cut = text.find(" #")
    return text[:cut].rstrip() if cut >= 0 else text


def _trailing(text: str, char: str) -> int:
    return len(text) - len(text.rstrip(char))


def _closed(text: str) -> bool:
    """Whether a quoted scalar's text has its closing quote."""
    body = text[1:]
    if text[:1] == "'":
        return _trailing(body, "'") % 2 == 1
    return body.endswith('"') and _trailing(body[:-1], "\\") % 2 == 0


_CONTENT, _BLANK, _COMMENT = 0, 1, 2


def _lines(text: str):
    """(indent, stripped text, kind) of every line."""
    out = []
    for raw in text.splitlines():
        stripped = raw.strip()
        kind = _BLANK if not stripped else _COMMENT if stripped.startswith("#") or stripped in ("---", "...") else _CONTENT
        out.append((len(raw) - len(raw.lstrip(" ")), stripped, kind))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Reader:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.i = self._skip(0)

    def _skip(self, i: int) -> int:
        """The index of the first content line at or after `i`."""
        while i < len(self.lines) and self.lines[i][2] != _CONTENT:
            i += 1
        return i

    @property
    def done(self) -> bool:
        return self.i >= len(self.lines)

    def _value(self, first: str, indent: int):
        """A scalar that starts with `first` and may go on over lines deeper
        than `indent`: a line break folds to a space, each blank line
        between two lines to a newline, and a double-quoted line ending in
        an escaping backslash joins the next directly."""
        text, quote = first, first[:1] if first[:1] in ("'", '"') else ""
        while not (quote and _closed(text)):
            j, blanks = self.i, 0
            while j < len(self.lines) and (self.lines[j][2] == _BLANK or (not quote and self.lines[j][2] == _COMMENT)):
                blanks += self.lines[j][2] == _BLANK
                j += 1
            if j >= len(self.lines):
                break
            at, nxt, _ = self.lines[j]
            if at <= indent or (not quote and (_is_item(nxt) or _key_of(nxt))):
                break
            if quote == '"' and not blanks and _trailing(text, "\\") % 2 == 1:
                text = text[:-1] + nxt
            else:
                text += "\n" * blanks if blanks else " "
                text += nxt
            self.i = j + 1
        self.i = self._skip(self.i)
        if quote and not _closed(text):
            raise ValueError(f"config file: unterminated quoted scalar {first!r}")
        return _scalar(_strip_comment(text))

    def block(self, indent: int):
        """The map or list whose entries sit at exactly `indent`."""
        if self.done:
            return None
        return self._sequence(indent) if _is_item(self.lines[self.i][1]) else self._mapping(indent)

    def _sequence(self, indent: int):
        out = []
        while not self.done:
            at, text, _ = self.lines[self.i]
            if at != indent or not _is_item(text):
                break
            self.i += 1
            out.append(self._value(text[2:].strip(), indent) if text != "-" else None)
        return out

    def _mapping(self, indent: int):
        out = {}
        while not self.done:
            at, text, _ = self.lines[self.i]
            if at != indent:
                if at > indent:
                    raise ValueError(f"config file: unexpected indentation at {text!r}")
                break
            key = _key_of(text)
            if key is None:
                raise ValueError(f"config file: expected 'key: value', got {text!r}")
            self.i += 1
            rest = text[len(key) + 1:].strip()
            name = _quoted(key) if key[:1] in ("'", '"') else key
            if rest:
                out[name] = self._value(rest, indent)
                continue
            self.i = self._skip(self.i)
            if not self.done and (self.lines[self.i][0] > indent or (
                    self.lines[self.i][0] == indent and _is_item(self.lines[self.i][1]))):
                out[name] = self.block(self.lines[self.i][0])
            else:
                out[name] = None
        return out


def _key_of(text: str):
    """The key of a ``key: value`` or ``key:`` line, else None."""
    m = re.match(r"""('(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^'"\s#\-][^:#]*?|-[^\s:][^:#]*?)\s*:(\s|$)""", text)
    return m.group(0).rstrip()[:-1].rstrip() if m else None


def parse_config(text: str) -> dict:
    """The dict a configuration file holds (what ``yaml.safe_load`` gives
    for the subset `dump_config` and JAX's writer produce)."""
    reader = _Reader(text)
    if reader.done:
        return {}
    value = reader.block(reader.lines[reader.i][0])
    if not reader.done:
        raise ValueError(f"config file: cannot read from {reader.lines[reader.i][1]!r}")
    return value if isinstance(value, dict) else {}


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        return text if ("." in text or "e" not in text) else text.replace("e", ".0e", 1)
    if not isinstance(value, str):
        raise TypeError(f"config file: cannot write a {type(value).__name__} ({value!r})")
    if _PLAIN_SAFE.fullmatch(value) and _plain_scalar(value) == value:
        return value
    if all(c.isprintable() for c in value):
        return "'" + value.replace("'", "''") + "'"
    return json.dumps(value)


def _dump_lines(value, indent: int):
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_dump_scalar(str(key))}:"
            if isinstance(item, dict) and item:
                yield head
                yield from _dump_lines(item, indent + 2)
            elif isinstance(item, (list, tuple)) and item:
                yield head
                yield from _dump_lines(list(item), indent)
            else:
                yield f"{head} {_dump_block_scalar(item)}"
    else:
        for item in value:
            if isinstance(item, (dict, list, tuple)) and item:
                raise TypeError("config file: lists hold scalars only")
            yield f"{pad}- {_dump_block_scalar(item)}"


def _dump_block_scalar(item) -> str:
    if isinstance(item, dict):
        return "{}"
    if isinstance(item, (list, tuple)):
        return "[]"
    return _dump_scalar(item)


def dump_config(config: dict) -> str:
    """`config` as block-style YAML, in its own key order."""
    return "".join(line + "\n" for line in _dump_lines(config, 0))


def write_basic_config(config_file=None, mixed_precision="bf16", **overrides):
    """Write `DEFAULT_CONFIG` with `mixed_precision` and `overrides` to
    `config_file` (default: `env.default_config_file()`); returns the path."""
    config = dict(DEFAULT_CONFIG)
    config["mixed_precision"] = mixed_precision
    config.update(overrides)
    config_file = config_file or default_config_file()
    os.makedirs(os.path.dirname(os.path.abspath(config_file)), exist_ok=True)
    with open(config_file, "w") as f:
        f.write(dump_config(config))
    return config_file


def load_config_file(config_file=None) -> dict:
    """The configuration in `config_file` (default: the default path), or
    {} when there is no such file."""
    config_file = config_file or default_config_file()
    if not os.path.isfile(config_file):
        return {}
    with open(config_file) as f:
        return parse_config(f.read()) or {}


# ------------------------------------------------------------------ the questionnaire
def _ask(prompt, default, cast=str):
    while True:
        raw = input(f"{prompt} [{default}]: ").strip()
        if not raw:
            return default
        if cast is bool:
            return raw.lower() in ("1", "true", "yes", "y")
        try:
            return cast(raw)
        except ValueError:
            print(f"Please enter a {cast.__name__}")


def run_questionnaire() -> dict:
    """JAX's interactive flow on this machine: mesh axes, FSDP/ZeRO,
    sequence parallelism, precision, accumulation and the runtime knobs."""
    from .menu import select_value

    config = dict(DEFAULT_CONFIG)
    config["compute_environment"] = "LOCAL_MACHINE"
    config["distributed_type"] = "XLA_SPMD"
    config["num_processes"] = 1

    mesh = {}
    if _ask("Customize the device mesh axes?", False, bool):
        for axis in MESH_AXES:
            default = -1 if axis == "data" else 1
            mesh[axis] = _ask(f"Mesh axis size `{axis}` (-1 = remaining devices)", default, int)
    else:
        mesh = dict(DEFAULT_CONFIG["mesh"])
    config["mesh"] = mesh

    if _ask("Use FSDP/ZeRO parameter sharding?", False, bool):
        fsdp = {}
        fsdp["sharding_strategy"] = select_value(
            "Sharding strategy", ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD"], "FULL_SHARD")
        fsdp["min_num_params"] = _ask("Min parameter count to shard (auto-wrap threshold)", 1024, int)
        fsdp["cpu_offload"] = _ask("Offload params/optimizer state to host memory?", False, bool)
        fsdp["activation_checkpointing"] = _ask("Activation checkpointing (remat)?", False, bool)
        fsdp["state_dict_type"] = select_value(
            "Checkpoint state-dict type", ["SHARDED_STATE_DICT", "FULL_STATE_DICT"], "SHARDED_STATE_DICT")
        config["fsdp_config"] = fsdp
        if mesh.get("fsdp", 1) == 1 and fsdp["sharding_strategy"] != "NO_SHARD":
            print("note: set mesh axis `fsdp` > 1 (or leave data=-1, fsdp=1 for pure DP) to shard across devices")

    if mesh.get("seq", 1) != 1 or _ask("Enable sequence/context parallelism (long sequences)?", False, bool):
        sp = {}
        sp["mode"] = select_value("Sequence-parallel attention", ["ring", "allgather"], "ring")
        sp["block_size"] = _ask("Ring attention block size", 512, int)
        config["sequence_parallel_config"] = sp
        if mesh.get("seq", 1) == 1:
            mesh["seq"] = _ask("Mesh axis size `seq`", 2, int)

    config["mixed_precision"] = select_value("Mixed precision", ["bf16", "no", "fp16", "fp8"], "bf16")
    if config["mixed_precision"] == "bf16":
        config["downcast_bf16"] = _ask("Downcast fp64->bf16 aggressively (downcast_bf16)?", False, bool)
    config["gradient_accumulation_steps"] = _ask("Gradient accumulation steps", 1, int)
    cache = _ask("Persistent XLA compilation cache dir (empty to disable)", "")
    if cache:
        config["compilation_cache"] = cache
    config["debug"] = _ask("Enable debug-mode collective verification?", False, bool)
    return config


def config_command(args):
    if args.default:
        path = write_basic_config(args.config_file)
        print(f"accelerate-tpu-torch configuration saved at {path}")
        return
    config = run_questionnaire()
    path = write_basic_config(args.config_file, **config)
    print(f"accelerate-tpu-torch configuration saved at {path}")
