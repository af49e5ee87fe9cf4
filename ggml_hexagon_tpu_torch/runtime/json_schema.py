"""JSON schema -> GBNF grammar (common/json-schema-to-grammar.cpp analog).

The port's own copy of ggml_hexagon_tpu/runtime/json_schema.py (the port imports nothing of
the JAX package).

Covers the practical subset: type object/array/string/number/integer/
boolean/null, enum/const, properties + required (fixed property order with
optional tails, like the reference), items / prefixItems, anyOf/oneOf,
local $ref/$defs, minItems/maxItems, additionalProperties: false implied.
"""
from __future__ import annotations

import json
import re

PRIMITIVES = {
    "space": '" "?',
    "string": r'"\"" ([^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}))* "\"" space',
    "number": '"-"? ([0-9] | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "integer": '"-"? ([0-9] | [1-9] [0-9]*) space',
    "boolean": '("true" | "false") space',
    "null": '"null" space',
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space (string ":" space value ("," space string ":" space value)*)? "}" space',
    "array": '"[" space (value ("," space value)*)? "]" space',
}


def _lit(s: str) -> str:
    """GBNF string literal for a JSON-encoded value."""
    return json.dumps(s) if not s.startswith('"') else s


class SchemaConverter:
    def __init__(self, schema: dict):
        self.schema = schema
        self.rules: dict[str, str] = {"space": PRIMITIVES["space"]}
        self.defs = schema.get("$defs", {}) | schema.get("definitions", {})

    def _add(self, name: str, body: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", name) or "rule"
        key = base
        i = 0
        while key in self.rules and self.rules[key] != body:
            i += 1
            key = f"{base}{i}"
        self.rules[key] = body
        return key

    def _prim(self, name: str) -> str:
        if name not in self.rules:
            if name in ("value", "object", "array"):
                for dep in ("string", "number", "boolean", "null", "value", "object", "array"):
                    if dep not in self.rules:
                        self.rules[dep] = PRIMITIVES[dep]
            else:
                self.rules[name] = PRIMITIVES[name]
        return name

    def visit(self, schema: dict | bool, name: str = "root") -> str:
        if schema is True or schema == {}:
            return self._prim("value")
        if "$ref" in schema:
            ref = schema["$ref"]
            key = ref.split("/")[-1]
            if key in self.defs:
                return self.visit(self.defs[key], key)
            raise ValueError(f"unresolvable $ref {ref}")
        if "const" in schema:
            return self._add(name, f"{json.dumps(json.dumps(schema['const']))} space")
        if "enum" in schema:
            alts = " | ".join(json.dumps(json.dumps(v)) for v in schema["enum"])
            return self._add(name, f"({alts}) space")
        for comb in ("anyOf", "oneOf"):
            if comb in schema:
                subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(schema[comb])]
                return self._add(name, " | ".join(subs))
        t = schema.get("type")
        if isinstance(t, list):
            subs = [self.visit({**schema, "type": ti}, f"{name}-{ti}") for ti in t]
            return self._add(name, " | ".join(subs))
        if t == "object" and "properties" in schema:
            required = set(schema.get("required", list(schema["properties"].keys())))
            props = list(schema["properties"].items())
            parts = []
            opt_tail = []
            first = True
            for k, sub in props:
                sub_rule = self.visit(sub, f"{name}-{k}")
                kv = f'{json.dumps(json.dumps(k))} space ":" space {sub_rule}'
                sep = '"," space ' if not first else ""
                piece = f"({sep}{kv})"
                if k in required:
                    parts.append(piece if not first else f"({kv})")
                else:
                    opt_tail.append(f"{piece}?" if not first else f"({kv})?")
                first = False
            body = '"{" space ' + " ".join(parts + opt_tail) + ' "}" space'
            return self._add(name, body)
        if t == "object":
            return self._prim("object")
        if t == "array":
            items = schema.get("items", True)
            sub = self.visit(items, f"{name}-item")
            mn = schema.get("minItems", 0)
            mx = schema.get("maxItems")
            if mn == 0 and mx is None:
                body = f'"[" space ({sub} ("," space {sub})*)? "]" space'
            else:
                reps = [sub] * mn
                if mx is None:
                    core = " (\",\" space ".join([sub] * max(mn, 1)) + ")" * (max(mn, 1) - 1)
                    body = (
                        f'"[" space {sub} ' + f'("," space {sub})' + "*"
                        f' "]" space'
                    ) if mn <= 1 else (
                        f'"[" space {sub} ' + " ".join([f'"," space {sub}'] * (mn - 1)) +
                        f' ("," space {sub})* "]" space'
                    )
                else:
                    head = [sub] + [f'"," space {sub}'] * (mn - 1) if mn else []
                    opts = [f'("," space {sub})?'] * (mx - max(mn, 1)) if mn else []
                    if mn == 0:
                        body = f'"[" space ({sub} ' + " ".join([f'("," space {sub})?'] * (mx - 1)) + ')? "]" space'
                    else:
                        body = '"[" space ' + " ".join(head + opts) + ' "]" space'
            return self._add(name, body)
        if t == "string":
            return self._prim("string")
        if t in ("number", "integer", "boolean", "null"):
            return self._prim(t)
        return self._prim("value")

    def to_gbnf(self) -> str:
        root = self.visit(self.schema, "root")
        lines = []
        if root != "root":
            lines.append(f"root ::= {root}")
        for k, v in self.rules.items():
            lines.append(f"{k} ::= {v}")
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return SchemaConverter(schema).to_gbnf()
