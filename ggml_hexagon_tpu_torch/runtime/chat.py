"""Chat templates — llama_chat_apply_template analog (src/llama-chat.cpp).

The port's own copy of ggml_hexagon_tpu/runtime/chat.py (the port imports nothing of
the JAX package).

The reference ships 36 hardcoded dialect formatters (src/llama-chat.h:8-43)
selected by fingerprinting the GGUF's `tokenizer.chat_template` Jinja source
(llm_chat_detect_template, src/llama-chat.cpp:72-185); arbitrary templates
render through the bundled minja Jinja engine.  Here: every reference dialect
is implemented as a small formatter, detection uses the same substring
fingerprints, and unknown templates render through jinja2 (the minja analog).

Dialect names follow the reference's LLM_CHAT_TEMPLATES registry keys
(src/llama-chat.cpp:28-66): chatml, llama2(-sys/-sys-bos/-sys-strip),
mistral-v1/v3/v3-tekken/v7, phi3, phi4, falcon3, zephyr, monarch, gemma,
orion, openchat, vicuna(-orca), deepseek, deepseek2, deepseek3, command-r,
llama3, chatglm3, chatglm4, glmedge, minicpm, exaone3, rwkv-world, granite,
gigachat, megrez, yandex, bailing.  Two local aliases predate the full set
and are kept for compatibility: "mistral" == mistral-v3, "llama2" ==
llama2-sys.
"""
from __future__ import annotations

from typing import Optional


def _trim(s: str) -> str:
    return s.strip()


# ---------------------------------------------------------------------------
# detection (llm_chat_detect_template, src/llama-chat.cpp:72-185)
# ---------------------------------------------------------------------------

def detect_template(tmpl_source: str) -> str:
    """Fingerprint a Jinja chat-template source.  Mirrors the reference's
    heuristic ordering so the same HF templates resolve to the same dialect."""
    t = tmpl_source
    if "<|im_start|>" in t:
        return "phi4" if "<|im_sep|>" in t else "chatml"
    if t.startswith("mistral") or "[INST]" in t:
        if "[SYSTEM_PROMPT]" in t:
            return "mistral-v7"
        if "' [INST] ' + system_message" in t or "[AVAILABLE_TOOLS]" in t:
            if " [INST]" in t:
                return "mistral-v1"
            if '"[INST]"' in t:
                return "mistral-v3-tekken"
            return "mistral-v3"
        if "content.strip()" in t:
            return "llama2-sys-strip"
        if "bos_token + '[INST]" in t:
            return "llama2-sys-bos"
        if "<<SYS>>" in t:
            return "llama2"  # local alias for the reference's llama2-sys
        # no system support and no official-mistral marker: the local
        # "mistral" alias matches prior behavior (plain [INST]..[/INST])
        return "mistral" if "[/INST]" in t else "llama2"
    if "<|assistant|>" in t and "<|end|>" in t:
        return "phi3"
    if "<|assistant|>" in t and "<|user|>" in t:
        return "falcon3" if "</s>" in t else "glmedge"
    if "<|user|>" in t and "<|endoftext|>" in t:
        return "zephyr"
    if "bos_token + message['role']" in t:
        return "monarch"
    if "<start_of_turn>" in t:
        return "gemma"
    if "'\\n\\nAssistant: ' + eos_token" in t:
        return "orion"
    if "GPT4 Correct " in t:
        return "openchat"
    if "USER: " in t and "ASSISTANT: " in t:
        return "vicuna-orca" if "SYSTEM: " in t else "vicuna"
    if "### Instruction:" in t and "<|EOT|>" in t:
        return "deepseek"
    if "<|START_OF_TURN_TOKEN|>" in t and "<|USER_TOKEN|>" in t:
        return "command-r"
    if "<|start_header_id|>" in t and ("<|end_header_id|>" in t or "<|eot_id|>" in t):
        return "llama3"
    if "[gMASK]sop" in t:
        return "chatglm3"
    if "[gMASK]<sop>" in t:
        return "chatglm4"
    if "<用户>" in t:
        return "minicpm"
    if "'Assistant: ' + message['content'] + eos_token" in t:
        return "deepseek2"
    if "<｜Assistant｜>" in t and "<｜User｜>" in t and "<｜end▁of▁sentence｜>" in t:
        return "deepseek3"
    if "[|system|]" in t and "[|assistant|]" in t and "[|endofturn|]" in t:
        return "exaone3"
    if "rwkv-world" in t:
        return "rwkv-world"
    if "<|start_of_role|>" in t:
        return "granite"
    if ("message['role'] + additional_special_tokens[0] + message['content']"
            " + additional_special_tokens[1]") in t:
        return "gigachat"
    if "<|role_start|>" in t:
        return "megrez"
    if " Ассистент:" in t:
        return "yandex"
    if "<role>ASSISTANT</role>" in t and "'HUMAN'" in t:
        return "bailing"
    # legacy local heuristics (kept so previously-detected sources stay stable)
    if "<|user|>" in t and "</s>" in t:
        return "zephyr"
    if "<｜User｜>" in t or ("User: " in t and "Assistant: " in t):
        return "deepseek3"
    return "unknown"


# ---------------------------------------------------------------------------
# formatters — one per dialect (llm_chat_apply_template bodies)
# ---------------------------------------------------------------------------

def _chatml(messages, add_assistant):
    out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
    if add_assistant:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _phi4(messages, add_assistant):
    out = [f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>" for m in messages]
    if add_assistant:
        out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _llama3(messages, add_assistant):
    # local convention: include the BOS text marker (the reference leaves BOS
    # to the tokenizer; our tokenizer layer does not re-add it for chat)
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{_trim(m['content'])}<|eot_id|>"
        )
    if add_assistant:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _llama2_family(messages, add_assistant, *, support_system=True,
                   bos_in_history=False, strip=False):
    """llama2 and its -sys/-sys-bos/-sys-strip variants: alternating
    [INST]..[/INST] turns, system folded into the first user turn."""
    out = ["[INST] "]
    inside = True
    for m in messages:
        content = _trim(m["content"]) if strip else m["content"]
        role = m["role"]
        if not inside:
            inside = True
            out.append("<s>[INST] " if bos_in_history else "[INST] ")
        if role == "system":
            if support_system:
                out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
            else:
                out.append(f"{content}\n")
        elif role == "user":
            out.append(f"{content} [/INST]")
        else:
            out.append(f"{content}</s>")
            inside = False
    return "".join(out)


def _mistral_v7(messages, add_assistant):
    out = []
    for m in messages:
        role, content = m["role"], m["content"]
        if role == "system":
            out.append(f"[SYSTEM_PROMPT] {content}[/SYSTEM_PROMPT]")
        elif role == "user":
            out.append(f"[INST] {content}[/INST]")
        else:
            out.append(f" {content}</s>")
    return "".join(out)


def _mistral_vx(messages, add_assistant, *, leading=" ", trailing=" ",
                trim_assistant=False):
    """Official mistral v1/v3/v3-tekken: system merged into the open turn."""
    out = []
    inside = False
    for m in messages:
        if not inside:
            out.append(f"{leading}[INST]{trailing}")
            inside = True
        role, content = m["role"], m["content"]
        if role == "system":
            out.append(f"{content}\n\n")
        elif role == "user":
            out.append(f"{content}{leading}[/INST]")
        else:
            body = _trim(content) if trim_assistant else content
            out.append(f"{trailing}{body}</s>")
            inside = False
    return "".join(out)


def _phi3(messages, add_assistant):
    out = [f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _falcon3(messages, add_assistant):
    out = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _zephyr(messages, add_assistant):
    out = [f"<|{m['role']}|>\n{m['content']}</s>\n" for m in messages]
    if add_assistant:
        out.append("<|assistant|>\n")
    return "".join(out)


def _monarch(messages, add_assistant):
    out = []
    for i, m in enumerate(messages):
        bos = "" if i == 0 else "<s>"
        out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    if add_assistant:
        out.append("<s>assistant\n")
    return "".join(out)


def _gemma(messages, add_assistant):
    out = []
    system = ""
    for m in messages:
        role = m["role"]
        if role == "system":
            system = _trim(m["content"])
            continue
        role = "model" if role == "assistant" else role
        out.append(f"<start_of_turn>{role}\n")
        if system and role != "model":
            out.append(f"{system}\n\n")
            system = ""
        out.append(f"{_trim(m['content'])}<end_of_turn>\n")
    if add_assistant:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _orion(messages, add_assistant):
    out = []
    system = ""
    for m in messages:
        role = m["role"]
        if role == "system":
            system = m["content"]
        elif role == "user":
            out.append("Human: ")
            if system:
                out.append(f"{system}\n\n")
                system = ""
            out.append(f"{m['content']}\n\nAssistant: </s>")
        else:
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _openchat(messages, add_assistant):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}<|end_of_turn|>")
        else:
            role = m["role"].capitalize()
            out.append(f"GPT4 Correct {role}: {m['content']}<|end_of_turn|>")
    if add_assistant:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _vicuna(messages, add_assistant, *, orca=False):
    out = []
    for m in messages:
        role = m["role"]
        if role == "system":
            out.append(f"SYSTEM: {m['content']}\n" if orca else f"{m['content']}\n\n")
        elif role == "user":
            out.append(f"USER: {m['content']}\n")
        elif role == "assistant":
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if add_assistant:
        out.append("ASSISTANT:")
    return "".join(out)


def _deepseek(messages, add_assistant):
    out = []
    for m in messages:
        role = m["role"]
        if role == "system":
            out.append(m["content"])
        elif role == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        elif role == "assistant":
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if add_assistant:
        out.append("### Response:\n")
    return "".join(out)


def _deepseek2(messages, add_assistant):
    out = []
    for m in messages:
        role = m["role"]
        if role == "system":
            out.append(f"{m['content']}\n\n")
        elif role == "user":
            out.append(f"User: {m['content']}\n\n")
        elif role == "assistant":
            out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
    if add_assistant:
        out.append("Assistant:")
    return "".join(out)


def _deepseek3(messages, add_assistant):
    out = []
    for m in messages:
        role = m["role"]
        if role == "system":
            out.append(f"{m['content']}\n\n")
        elif role == "user":
            out.append(f"<｜User｜>{m['content']}")
        else:
            out.append(f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>")
    if add_assistant:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _command_r(messages, add_assistant):
    token = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
             "assistant": "<|CHATBOT_TOKEN|>"}
    out = [
        f"<|START_OF_TURN_TOKEN|>{token[m['role']]}{_trim(m['content'])}<|END_OF_TURN_TOKEN|>"
        for m in messages if m["role"] in token
    ]
    if add_assistant:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _chatglm3(messages, add_assistant):
    out = ["[gMASK]sop"]
    out += [f"<|{m['role']}|>\n {m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _chatglm4(messages, add_assistant):
    out = ["[gMASK]<sop>"]
    out += [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _glmedge(messages, add_assistant):
    out = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    if add_assistant:
        out.append("<|assistant|>")
    return "".join(out)


def _minicpm(messages, add_assistant):
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"<用户>{_trim(m['content'])}<AI>")
        else:
            out.append(_trim(m["content"]))
    return "".join(out)


def _exaone3(messages, add_assistant):
    out = []
    for m in messages:
        role = m["role"]
        if role == "system":
            out.append(f"[|system|]{_trim(m['content'])}[|endofturn|]\n")
        elif role == "user":
            out.append(f"[|user|]{_trim(m['content'])}\n")
        elif role == "assistant":
            out.append(f"[|assistant|]{_trim(m['content'])}[|endofturn|]\n")
    if add_assistant:
        out.append("[|assistant|]")
    return "".join(out)


def _rwkv_world(messages, add_assistant):
    # the model uses "\n\n" as EOT; user turns pre-open the assistant turn
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"User: {m['content']}\n\nAssistant:")
        else:
            out.append(f"{m['content']}\n\n")
    return "".join(out)


def _granite(messages, add_assistant):
    out = []
    for m in messages:
        role = m["role"]
        out.append(f"<|start_of_role|>{role}<|end_of_role|>")
        if role == "assistant_tool_call":
            out.append("<|tool_call|>")
        out.append(f"{m['content']}<|end_of_text|>\n")
    if add_assistant:
        out.append("<|start_of_role|>assistant<|end_of_role|>\n")
    return "".join(out)


def _gigachat(messages, add_assistant):
    out = []
    msgs = list(messages)
    if msgs and msgs[0]["role"] == "system":
        out.append(f"<s>{msgs[0]['content']}<|message_sep|>")
        msgs = msgs[1:]
    else:
        out.append("<s>")
    for m in msgs:
        if m["role"] == "user":
            out.append(f"user<|role_sep|>{m['content']}<|message_sep|>"
                       "available functions<|role_sep|>[]<|message_sep|>")
        elif m["role"] == "assistant":
            out.append(f"assistant<|role_sep|>{m['content']}<|message_sep|>")
    if add_assistant:
        out.append("assistant<|role_sep|>")
    return "".join(out)


def _megrez(messages, add_assistant):
    out = [f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>"
           for m in messages]
    if add_assistant:
        out.append("<|role_start|>assistant<|role_end|>")
    return "".join(out)


def _yandex(messages, add_assistant):
    out = ["<s>"]
    for m in messages:
        if m["role"] == "user":
            out.append(f" Пользователь: {m['content']}\n\n")
        elif m["role"] == "assistant":
            out.append(f" Ассистент: {m['content']}\n\n")
    if add_assistant:
        out.append(" Ассистент:[SEP]")
    return "".join(out)


def _bailing(messages, add_assistant):
    out = []
    for m in messages:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out.append(f"<role>{role}</role>{m['content']}")
    if add_assistant:
        out.append("<role>ASSISTANT</role>")
    return "".join(out)


FORMATTERS = {
    "chatml": _chatml,
    "phi4": _phi4,
    "llama3": _llama3,
    # llama2 family ("llama2" keeps the local alias == reference llama2-sys)
    "llama2": lambda m, a: _llama2_family(m, a, support_system=True),
    "llama2-sys": lambda m, a: _llama2_family(m, a, support_system=True),
    "llama2-nosys": lambda m, a: _llama2_family(m, a, support_system=False),
    "llama2-sys-bos": lambda m, a: _llama2_family(m, a, bos_in_history=True),
    "llama2-sys-strip": lambda m, a: _llama2_family(m, a, strip=True),
    # mistral family ("mistral" keeps the local alias == v3 spacing)
    "mistral": lambda m, a: _mistral_vx(m, a, leading="", trailing=" ", trim_assistant=True),
    "mistral-v1": lambda m, a: _mistral_vx(m, a, leading=" ", trailing=" "),
    "mistral-v3": lambda m, a: _mistral_vx(m, a, leading="", trailing=" ", trim_assistant=True),
    "mistral-v3-tekken": lambda m, a: _mistral_vx(m, a, leading="", trailing=""),
    "mistral-v7": _mistral_v7,
    "phi3": _phi3,
    "falcon3": _falcon3,
    "zephyr": _zephyr,
    "monarch": _monarch,
    "gemma": _gemma,
    "orion": _orion,
    "openchat": _openchat,
    "vicuna": lambda m, a: _vicuna(m, a, orca=False),
    "vicuna-orca": lambda m, a: _vicuna(m, a, orca=True),
    "deepseek": _deepseek,
    "deepseek2": _deepseek2,
    "deepseek3": _deepseek3,
    "command-r": _command_r,
    "chatglm3": _chatglm3,
    "chatglm4": _chatglm4,
    "glmedge": _glmedge,
    "minicpm": _minicpm,
    "exaone3": _exaone3,
    "rwkv-world": _rwkv_world,
    "granite": _granite,
    "gigachat": _gigachat,
    "megrez": _megrez,
    "yandex": _yandex,
    "bailing": _bailing,
}


def apply_chat_template(
    messages: list[dict],
    template: str = "chatml",
    add_assistant: bool = True,
    jinja_source: Optional[str] = None,
    bos_token: str = "<s>",
    eos_token: str = "</s>",
) -> str:
    """Format messages.  `template` is a dialect name; `jinja_source` (the
    GGUF's tokenizer.chat_template) renders via jinja2 when given and the
    dialect is unknown."""
    if template in FORMATTERS:
        return FORMATTERS[template](messages, add_assistant)
    if jinja_source is None:
        raise ValueError(f"unknown template {template!r}; known: {sorted(FORMATTERS)}")
    import jinja2

    env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
    env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(ValueError(msg))
    tmpl = env.from_string(jinja_source)
    return tmpl.render(
        messages=messages,
        add_generation_prompt=add_assistant,
        bos_token=bos_token,
        eos_token=eos_token,
    )


def template_from_gguf(metadata: dict) -> tuple[str, Optional[str]]:
    """(dialect, jinja_source) from GGUF metadata."""
    src = metadata.get("tokenizer.chat_template")
    if not src:
        return "chatml", None
    return detect_template(src), src
