"""Tool-call formats: prompt-side tool injection + output parsing.

The port's own copy of ggml_hexagon_tpu/runtime/toolcall.py (the port imports nothing of
the JAX package).

Reference counterpart: common/chat.cpp (+ chat.h:45-60 common_chat_format —
15 dialects) — renders the tool list into the prompt per model family and
parses the generated text back into structured tool calls, including
DeepSeek-R1 reasoning extraction.  The llama-server surfaces this through
/v1/chat/completions `tools` / `tool_calls` (server.cpp oaicompat paths).

Formats covered (detection mirrors common_chat_templates_apply's
marker-based dispatch):
  generic            bare JSON {"tool_call": {...}} / {"name": ..., "arguments"}
  hermes_2_pro       <tool_call>{...}</tool_call>
  llama_3x           {"name": ..., "parameters": {...}}
  llama_3x_builtin   + <|python_tag|>tool.call(arg=value) builtin-tool syntax
  mistral_nemo       [TOOL_CALLS][{...}, ...]
  firefunction       functools[{...}, ...]
  functionary_v3_2   >>>fn_name\n{args} sections (>>>all = plain content)
  functionary_v3_1   <function=name>{args}</function> + <|python_tag|>code
  deepseek_r1        <think>reasoning</think> + tool-call JSON markers
  command_r7b        <|START_THINKING|>/<|START_ACTION|> blocks
reasoning-extraction variants of deepseek_r1/hermes/command_r7b are the
`extract_reasoning` flag rather than separate format ids.
"""
from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field


@dataclass
class ToolCall:
    name: str
    arguments: str  # JSON-encoded string (OpenAI wire format)
    id: str = ""


@dataclass
class ChatParse:
    content: str = ""
    reasoning: str = ""
    tool_calls: list = field(default_factory=list)


def detect_format(template_source: str | None) -> str:
    """Pick the tool-call dialect from chat-template markers
    (common_chat_templates_apply's source sniffing)."""
    src = template_source or ""
    if "<tool_call>" in src:
        return "hermes_2_pro"
    if "[TOOL_CALLS]" in src:
        return "mistral_nemo"
    if "<|START_ACTION|>" in src or "<|START_THINKING|>" in src:
        return "command_r7b"
    if " functools[" in src or "functools[" in src:
        return "firefunction"
    if "<｜tool▁calls▁begin｜>" in src or "<|tool_calls_begin|>" in src:
        return "deepseek_r1"
    if ">>>all" in src:
        return "functionary_v3_2"
    if "<|start_header_id|>" in src and "<function=" in src:
        return "functionary_v3_1"
    if "<|start_header_id|>ipython<|end_header_id|>" in src:
        return "llama_3x_builtin" if "<|python_tag|>" in src else "llama_3x"
    if "<|python_tag|>" in src or "ipython" in src:
        return "llama_3x"
    return "generic"


def render_tools_prompt(tools: list, fmt: str = "generic") -> str:
    """System-prompt block describing the available tools (the
    chat.cpp per-format prompt additions, normalized to one shape)."""
    if not tools:
        return ""
    specs = json.dumps(tools, indent=2)
    if fmt == "hermes_2_pro":
        return ("You are a function calling AI model. You may call one or "
                "more functions to assist with the user query. Here are the "
                "available tools: <tools>" + specs + "</tools> For each "
                "function call, return a json object inside "
                "<tool_call></tool_call> tags with the function name and "
                "arguments.\n")
    if fmt == "functionary_v3_2":
        return ("You have access to the following functions; to call one, "
                "respond with sections of the form >>>function_name\n"
                "{arguments json} (use >>>all for plain text):\n" + specs + "\n")
    if fmt == "functionary_v3_1":
        return ("You have access to the following functions; to call one, "
                "respond with <function=function_name>{arguments json}"
                "</function>:\n" + specs + "\n")
    if fmt in ("llama_3x", "llama_3x_builtin"):
        return ("Environment: ipython\nYou have access to the following "
                "functions; to call one respond with JSON "
                '{"name": function name, "parameters": arguments dict}:\n'
                + specs + "\n")
    return ("You have access to the following tools; to use one, respond "
            'with JSON {"tool_call": {"name": ..., "arguments": {...}}}:\n'
            + specs + "\n")


def _mk(name, args) -> ToolCall:
    if not isinstance(args, str):
        args = json.dumps(args)
    return ToolCall(name=name, arguments=args, id=uuid.uuid4().hex[:9])


def _json_objects(text: str):
    """Yield (obj, span) for every parseable top-level JSON object/array."""
    dec = json.JSONDecoder()
    i = 0
    while i < len(text):
        if text[i] in "[{":
            try:
                obj, end = dec.raw_decode(text, i)
                yield obj, (i, end)
                i = end
                continue
            except ValueError:
                pass
        i += 1


def _from_obj(obj) -> ToolCall | None:
    if not isinstance(obj, dict):
        return None
    if "tool_call" in obj and isinstance(obj["tool_call"], dict):
        obj = obj["tool_call"]
    name = obj.get("name")
    args = obj.get("arguments", obj.get("parameters"))
    if isinstance(name, str) and args is not None:
        return _mk(name, args)
    return None


def parse_chat_output(text: str, fmt: str = "generic",
                      extract_reasoning: bool = True) -> ChatParse:
    """Generated text -> (content, reasoning, tool_calls)
    (common_chat_parse dispatch, chat.cpp)."""
    out = ChatParse()
    if extract_reasoning:
        m = re.search(r"<think>(.*?)</think>\s*", text, re.S)
        if m:
            out.reasoning = m.group(1).strip()
            text = text[: m.start()] + text[m.end():]
        m = re.search(r"<\|START_THINKING\|>(.*?)<\|END_THINKING\|>\s*",
                      text, re.S)
        if m:
            out.reasoning = m.group(1).strip()
            text = text[: m.start()] + text[m.end():]

    if fmt == "hermes_2_pro":
        def sub(m):
            for obj, _ in _json_objects(m.group(1)):
                tc = _from_obj(obj)
                if tc:
                    out.tool_calls.append(tc)
            return ""
        text = re.sub(r"<tool_call>\s*(.*?)\s*</tool_call>", sub, text,
                      flags=re.S)
    elif fmt == "mistral_nemo":
        m = re.search(r"\[TOOL_CALLS\]\s*(\[.*)", text, re.S)
        if m:
            for obj, _ in _json_objects(m.group(1)):
                for item in obj if isinstance(obj, list) else [obj]:
                    tc = _from_obj(item)
                    if tc:
                        if isinstance(item, dict) and item.get("id"):
                            tc.id = str(item["id"])
                        out.tool_calls.append(tc)
                break
            text = text[: m.start()]
    elif fmt == "firefunction":
        m = re.search(r"functools\s*(\[.*)", text, re.S)
        if m:
            for obj, _ in _json_objects(m.group(1)):
                for item in obj if isinstance(obj, list) else [obj]:
                    tc = _from_obj(item)
                    if tc:
                        out.tool_calls.append(tc)
                break
            text = text[: m.start()]
    elif fmt == "command_r7b":
        m = re.search(r"<\|START_ACTION\|>(.*?)<\|END_ACTION\|>", text, re.S)
        if m:
            for obj, _ in _json_objects(m.group(1)):
                for item in obj if isinstance(obj, list) else [obj]:
                    if isinstance(item, dict):
                        name = item.get("tool_name", item.get("name"))
                        args = item.get("parameters", item.get("arguments", {}))
                        if name:
                            out.tool_calls.append(_mk(name, args))
                break
            text = text[: m.start()] + text[m.end():]
        text = re.sub(r"<\|START_RESPONSE\|>|<\|END_RESPONSE\|>", "", text)
    elif fmt == "functionary_v3_2":
        # ">>>all\ncontent>>>fn1\n{...}>>>fn2\n{...}" — the first section may
        # omit the ">>>" prefix; "all" is the plain-content pseudo-function
        # (common_chat_parse_functionary_v3_2, common/chat.cpp:1248)
        parts = re.split(r">>>(?:assistant<\|end_header_id\|>\n)?", text)
        content = []
        for i, part in enumerate(parts):
            m = re.match(r"(\w+)\n", part)
            if not m:
                if part:
                    content.append(part)
                continue
            name, body = m.group(1), part[m.end():]
            if name == "all":
                content.append(body)
                continue
            parsed = False
            for obj, _ in _json_objects(body):
                out.tool_calls.append(_mk(name, obj))
                parsed = True
                break
            if not parsed and i == 0:
                content.append(part)
        text = "".join(content)
    elif fmt == "functionary_v3_1":
        # <function=name>{...}</function>; the llama-3.1 python builtin
        # survives as <|python_tag|>code -> python({"code": ...})
        # (common_chat_parse_functionary_v3_1_llama_3_1, common/chat.cpp:1337)
        m = re.search(r"<\|python_tag\|>([\s\S]*)$", text)
        if m:
            out.tool_calls.append(_mk("python", {"code": m.group(1)}))
            text = text[: m.start()]
        else:
            def sub31(m):
                for obj, _ in _json_objects(m.group(2)):
                    out.tool_calls.append(_mk(m.group(1), obj))
                    break
                return ""
            text = re.sub(r"<function=(\w+)>(.*?)</function>", sub31, text,
                          flags=re.S)
    elif fmt == "llama_3x_builtin":
        # <|python_tag|>tool.call(key=json_value, ...) — builtin tools
        # (common_chat_parse_llama_3_1 builtin_call_regex, common/chat.cpp:1019)
        m = re.match(r"<\|python_tag\|>\s*([^.(]+)\s*\.\s*call\s*\((.*)\)\s*$",
                     text, re.S)
        if m:
            name, argstr = m.group(1).strip(), m.group(2)
            args = {}
            dec = json.JSONDecoder()
            i = 0
            while i < len(argstr):
                km = re.compile(r"\s*(\w+)\s*=\s*").match(argstr, i)
                if not km:
                    break
                try:
                    val, end = dec.raw_decode(argstr, km.end())
                except ValueError:
                    args = None
                    break
                args[km.group(1)] = val
                i = end
                cm = re.compile(r"\s*,").match(argstr, i)
                i = cm.end() if cm else i
            if args:
                out.tool_calls.append(_mk(name, args))
                text = ""
        if not out.tool_calls:
            # no builtin syntax: fall back to the plain llama_3x JSON shape
            spans = []
            for obj, span in _json_objects(text):
                tc = _from_obj(obj)
                if tc:
                    out.tool_calls.append(tc)
                    spans.append(span)
            for s, e in reversed(spans):
                text = text[:s] + text[e:]
    elif fmt == "deepseek_r1":
        text = re.sub(
            r"<[|｜]tool[▁_]calls[▁_]begin[|｜]>.*", lambda m: _ds(m, out),
            text, flags=re.S)
    else:  # generic / llama_3x: bare JSON tool calls anywhere in the text
        text = re.sub(r"<\|python_tag\|>", "", text)
        spans = []
        for obj, span in _json_objects(text):
            tc = _from_obj(obj)
            if tc:
                out.tool_calls.append(tc)
                spans.append(span)
        for s, e in reversed(spans):
            text = text[:s] + text[e:]

    out.content = text.strip()
    return out


def _ds(m, out: ChatParse) -> str:
    for obj, _ in _json_objects(m.group(0)):
        tc = _from_obj(obj)
        if tc:
            out.tool_calls.append(tc)
    return ""


def tool_calls_json(parse: ChatParse) -> list[dict]:
    """OpenAI wire shape for /v1/chat/completions responses."""
    return [{
        "id": f"call_{tc.id}",
        "type": "function",
        "function": {"name": tc.name, "arguments": tc.arguments},
    } for tc in parse.tool_calls]
