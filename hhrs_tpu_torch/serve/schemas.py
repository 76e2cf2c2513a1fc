"""Request contract of the REST surface, validated without pydantic.

Counterpart of ``hhrs_tpu/serve/schemas.py``: ``RecommendationRequest``
takes the same fields and rules (``user_id: int`` and ``city: str``
required, ``type: str = "friends"``, ``0 ≤ lambda_param ≤ 1`` with default
0.7), and :meth:`RecommendationRequest.model_validate` /
:meth:`~RecommendationRequest.model_validate_json` accept, coerce and
reject what pydantic v2 does in its default lax mode:

* an ``int`` takes an int, a bool, a finite integral float strictly inside
  ±2⁶³, or a string of an integer (surrounding Unicode whitespace,
  underscores between digits and a ``.0…`` tail allowed; at most 4,300
  characters);
* a ``float`` takes an int, a float (inf and NaN too), a bool, or a string
  of a decimal or ``inf``/``infinity``/``nan`` (any case, signed), with
  Rust's number grammar, and then meets its bounds;
* a ``str`` takes a string only;
* unknown keys are ignored; errors come in field order, each a
  ``{"type", "loc", "msg", "input"}`` dict with pydantic's ``type`` and
  ``loc``.

``model_validate_json`` parses the body as pydantic's JSON parser does:
strict UTF-8 without a byte-order mark, ``NaN`` / ``Infinity`` /
``-Infinity`` allowed, no lone surrogate escapes, at most 201 nested
containers, integers of at most 4,300 digits; any other body is one
``json_invalid`` error. There a float field takes an integer too large for
a float as ±inf, where ``model_validate`` raises ``float_type``.

The response models of the JAX module are documentation only there; the
port's OpenAPI document keeps their schemas as data (``openapi.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re

# The batch endpoint's padded bucket and request cap, one source for the
# enforced and the published contract.
HTTP_BATCH_PAD = 64

_I64 = 2.0 ** 63
_MAX_INT_CHARS = 4300
_MAX_JSON_DEPTH = 201
# Unicode White_Space: what Rust's str::trim strips around a number
_WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
               "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_JSON_INT_RE = re.compile(r"-?(?:0|[1-9][0-9]*)")
_INT_RE = re.compile(r"([+-]?)([0-9]+)\Z")
_FLOAT_RE = re.compile(r"[+-]?(?:inf|infinity|nan|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?)\Z",
                       re.IGNORECASE)
_SURROGATE_RE = re.compile("[\ud800-\udfff]")


class ValidationError(ValueError):
    """Invalid input: :meth:`errors` lists each fault as pydantic does."""

    def __init__(self, errors: list):
        self._errors = errors
        super().__init__(str(self))

    def errors(self) -> list:
        """``[{"type", "loc", "msg", "input"}, …]``, JSON-serializable
        (non-finite floats in ``input`` become None, as pydantic's
        ``ValidationError.json()`` writes them)."""
        return [dict(e, loc=list(e["loc"]), input=_json_safe(e["input"])) for e in self._errors]

    def __str__(self) -> str:
        n = len(self._errors)
        lines = [f"{n} validation error{'s' if n != 1 else ''} for RecommendationRequest"]
        for e in self._errors:
            lines.append(".".join(str(x) for x in e["loc"]) or "(root)")
            lines.append(f"  {e['msg']} [type={e['type']}, input_value={e['input']!r}]")
        return "\n".join(lines)


def _json_safe(value):
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: _json_safe(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_json_safe(v) for v in value]
    return value


class _Fault(Exception):
    def __init__(self, type_: str, msg: str):
        super().__init__(msg)
        self.type, self.msg = type_, msg


def _strip_underscores(s: str) -> str | None:
    """``s`` without its underscores, where each stands between two other
    characters and no two are adjacent; else None."""
    if not s or s[0] == "_" or s[-1] == "_" or "__" in s:
        return None
    return s.replace("_", "")


def _strip_decimal_zeros(s: str) -> str:
    """``"12.00"`` → ``"12"``: a ``.`` followed by one or more zeros and
    nothing else is dropped."""
    i = s.find(".")
    if i >= 0 and len(s) > i + 1 and s[i + 1:].strip("0") == "":
        return s[:i]
    return s


def _int_from_str(s: str) -> int:
    """pydantic's string → int: the string as a JSON integer (more than
    4,300 characters is ``int_parsing_size``); failing that, trimmed, with
    a ``.0…`` tail and underscores stripped, an optional sign and ASCII
    digits, at most 4,300 characters once a ``+`` and leading zeros are
    dropped."""
    m = _JSON_INT_RE.match(s)
    if m and m.end() > _MAX_INT_CHARS:
        raise _Fault("int_parsing_size", "Unable to parse input string as an integer, exceeded maximum size")
    if m and m.end() == len(s):
        return int(s)
    t = _strip_decimal_zeros(s.strip(_WHITESPACE))
    if "_" in t:
        t = _strip_underscores(t) or ""
    m = _INT_RE.match(t)
    if m:
        sign, digits = m.group(1), m.group(2).lstrip("0") or "0"
        if len(digits) + (sign == "-") <= _MAX_INT_CHARS:
            return int(sign + digits)
    raise _Fault("int_parsing", "Input should be a valid integer, unable to parse string as an integer")


def _float_from_str(s: str) -> float:
    t = s.strip(_WHITESPACE)
    if not _FLOAT_RE.match(t):
        t = _strip_underscores(s)  # the untrimmed string, then no trimming
        if t is None or not _FLOAT_RE.match(t):
            raise _Fault("float_parsing", "Input should be a valid number, unable to parse string as a number")
    return float(t)


def _as_int(value) -> int:
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if not math.isfinite(value):
            raise _Fault("finite_number", "Input should be a finite number")
        if value % 1.0 != 0.0:
            raise _Fault("int_from_float", "Input should be a valid integer, got a number with a fractional part")
        if not -_I64 < value < _I64:
            raise _Fault("int_parsing_size", "Unable to parse input string as an integer, exceeded maximum size")
        return int(value)
    if isinstance(value, str):
        return _int_from_str(value)
    raise _Fault("int_type", "Input should be a valid integer")


def _as_float(value, json_mode: bool) -> float:
    if isinstance(value, (bool, float)):
        return float(value)
    if isinstance(value, int):
        try:
            return float(value)
        except OverflowError:
            if json_mode:  # a JSON integer beyond float range parses as ±inf
                return math.inf if value > 0 else -math.inf
            raise _Fault("float_type", "Input should be a valid number") from None
    if isinstance(value, str):
        return _float_from_str(value)
    raise _Fault("float_type", "Input should be a valid number")


def _as_str(value) -> str:
    if isinstance(value, str):
        return value
    raise _Fault("string_type", "Input should be a valid string")


def _lambda(value, json_mode: bool) -> float:
    x = _as_float(value, json_mode)
    if not x <= 1.0:
        raise _Fault("less_than_equal", "Input should be less than or equal to 1")
    if not x >= 0.0:
        raise _Fault("greater_than_equal", "Input should be greater than or equal to 0")
    return x


_MISSING = object()


def _check_json_value(value, depth: int = 1) -> None:
    """Raise ``ValueError`` where pydantic's JSON parser refuses what
    Python's accepted: containers nested deeper than 201, or a lone
    surrogate in a string."""
    if isinstance(value, str):
        if _SURROGATE_RE.search(value):
            raise ValueError("lone surrogate in a string")
        return
    if isinstance(value, (dict, list)):
        if depth > _MAX_JSON_DEPTH:
            raise ValueError("recursion limit exceeded")
        items = value.items() if isinstance(value, dict) else ((None, v) for v in value)
        for k, v in items:
            if k is not None:
                _check_json_value(k, depth)
            _check_json_value(v, depth + 1)


def parse_json(raw: bytes):
    """The JSON value of ``raw`` as pydantic's parser reads it; raises
    :class:`ValidationError` (``json_invalid``) where that parser refuses."""
    try:
        value = json.loads(raw.decode("utf-8"))
        _check_json_value(value)
    except (UnicodeDecodeError, ValueError, RecursionError) as e:
        msg = e.msg if isinstance(e, json.JSONDecodeError) else str(e)
        raise ValidationError([{"type": "json_invalid", "loc": (), "msg": f"Invalid JSON: {msg}",
                                "input": raw.decode("utf-8", "replace")}]) from None
    return value


@dataclasses.dataclass(frozen=True)
class RecommendationRequest:
    """POST /recommendations body (reference main.py:23-33)."""

    user_id: int
    city: str
    type: str = "friends"
    lambda_param: float = 0.7

    @classmethod
    def model_validate(cls, value) -> "RecommendationRequest":
        """Validate a decoded JSON value (pydantic's python mode)."""
        return cls._validate(value, json_mode=False)

    @classmethod
    def model_validate_json(cls, raw: bytes) -> "RecommendationRequest":
        """Validate a raw JSON body (pydantic's JSON mode)."""
        return cls._validate(parse_json(raw), json_mode=True)

    @classmethod
    def _validate(cls, value, json_mode: bool) -> "RecommendationRequest":
        if not isinstance(value, dict):
            msg = ("Input should be an object" if json_mode else
                   "Input should be a valid dictionary or instance of RecommendationRequest")
            raise ValidationError([{"type": "model_type", "loc": (), "msg": msg, "input": value}])
        fields = (("user_id", _as_int, _MISSING), ("city", _as_str, _MISSING),
                  ("type", _as_str, "friends"), ("lambda_param", lambda v: _lambda(v, json_mode), 0.7))
        out, errors = {}, []
        for name, coerce, default in fields:
            raw = value.get(name, _MISSING)
            if raw is _MISSING:
                if default is _MISSING:
                    errors.append({"type": "missing", "loc": (name,), "msg": "Field required", "input": value})
                else:
                    out[name] = default
                continue
            try:
                out[name] = coerce(raw)
            except _Fault as f:
                errors.append({"type": f.type, "loc": (name,), "msg": f.msg, "input": raw})
        if errors:
            raise ValidationError(errors)
        return cls(**out)
