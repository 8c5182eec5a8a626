"""A dataclass -> argparse command line (port of
gscodec_studio_tpu/utils/cli.py) for flat dataclasses with bool, int,
float, str, Optional and tuple fields, with named presets.

The field types come from ``typing.get_type_hints``, so that they are
types even where the dataclass's module has ``from __future__ import
annotations`` (each ``Field.type`` is then a string; the JAX package's
parser reads those and leaves every int and float a string). A bare
``tuple`` field takes its elements' type from its default's first
element; an Optional field also takes ``none``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
from typing import Dict, Optional, Type, TypeVar

T = TypeVar("T")


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _optional(elem):
    def parse(s: str):
        return None if s.lower() == "none" else elem(s)

    return parse


def _add_field(parser: argparse.ArgumentParser, name: str, ftype, default):
    flag = "--" + name.replace("_", "-")
    origin = typing.get_origin(ftype)
    args = typing.get_args(ftype)
    if origin is typing.Union and type(None) in args:
        ftype = next(a for a in args if a is not type(None))
        origin, args = typing.get_origin(ftype), typing.get_args(ftype)
        optional = True
    else:
        optional = False
    if ftype is bool:
        parser.add_argument(flag, type=_bool, default=default, nargs="?",
                            const=True)
    elif ftype in (tuple, list) or origin in (tuple, list):
        elem = args[0] if args else (type(default[0]) if default else str)
        parser.add_argument(flag, type=elem, nargs="*", default=default)
    else:
        base = ftype if isinstance(ftype, type) else str
        parser.add_argument(flag, type=_optional(base) if optional else base,
                            default=default)


def parse_config(
    config_cls: Type[T],
    presets: Optional[Dict[str, T]] = None,
    argv=None,
) -> T:
    """``config_cls`` from ``argv`` (sys.argv[1:] when None): where
    ``presets`` are given, optionally a preset's name first (else the
    class's defaults), then one --field-name flag per field. A tuple
    field's values come back as a tuple."""
    argv = list(sys.argv[1:] if argv is None else argv)
    base = config_cls()
    if presets and argv and not argv[0].startswith("-"):
        if argv[0] not in presets:
            raise SystemExit(f"unknown preset {argv[0]!r}: "
                             f"{', '.join(sorted(presets))}")
        base, argv = presets[argv[0]], argv[1:]
    hints = typing.get_type_hints(config_cls)
    parser2 = argparse.ArgumentParser()
    for f in dataclasses.fields(config_cls):
        _add_field(parser2, f.name, hints[f.name], getattr(base, f.name))
    ns = vars(parser2.parse_args(argv))
    for f in dataclasses.fields(config_cls):
        if isinstance(ns[f.name], list):
            ns[f.name] = tuple(ns[f.name])
    return dataclasses.replace(base, **ns)
