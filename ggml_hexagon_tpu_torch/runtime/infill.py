"""Fill-in-middle prompt construction (format_infill,

The port's own copy of ggml_hexagon_tpu/runtime/infill.py (the port imports nothing of
the JAX package).
examples/server/utils.hpp — repo-level FIM pattern from arXiv:2409.12186):

    [FIM_REP]myproject
    [FIM_SEP]filename0
    extra chunk 0
    ...
    [FIM_SEP]filename
    [FIM_PRE]prefix[FIM_SUF]suffix[FIM_MID]

Shared by `cli.py infill` and the server's POST /infill.
"""
from __future__ import annotations

_FIM_KEYS = {
    "pre": ("tokenizer.ggml.fim_pre_token_id", "tokenizer.ggml.prefix_token_id"),
    "suf": ("tokenizer.ggml.fim_suf_token_id", "tokenizer.ggml.suffix_token_id"),
    "mid": ("tokenizer.ggml.fim_mid_token_id", "tokenizer.ggml.middle_token_id"),
    "rep": ("tokenizer.ggml.fim_rep_token_id",),
    "sep": ("tokenizer.ggml.fim_sep_token_id",),
}


def fim_tokens(md: dict) -> dict:
    """FIM special-token ids from GGUF metadata (None where absent)."""
    out = {}
    for k, keys in _FIM_KEYS.items():
        out[k] = None
        for key in keys:
            v = md.get(key)
            if v is not None:
                out[k] = int(v)
                break
    return out


def format_infill(md: dict, tokenizer, input_prefix: str, input_suffix: str,
                  prompt_tokens: list | None = None, input_extra: list | None = None,
                  n_batch: int = 2048, n_predict: int = 64,
                  n_ctx: int = 4096, spm_infill: bool = False) -> list:
    """Build the FIM token sequence (format_infill, utils.hpp).

    input_extra: [{"filename": str, "text": str}, ...] repo-level chunks.
    Raises ValueError when the model lacks FIM special tokens.
    """
    fim = fim_tokens(md)
    if None in (fim["pre"], fim["suf"], fim["mid"]):
        raise ValueError("model lacks FIM pre/suf/mid special tokens")
    enc = lambda s: tokenizer.encode(s, add_bos=False)  # noqa: E731

    extra = []
    if fim["rep"] is not None:
        extra += [fim["rep"], *enc("myproject\n")]
    for chunk in (input_extra or []):
        text = chunk.get("text", "")
        filename = chunk.get("filename", "tmp")
        if fim["sep"] is not None:
            extra += [fim["sep"], *enc(filename + "\n")]
        else:
            extra += enc("\n\n--- snippet ---\n\n")
        extra += enc(text)
    if fim["sep"] is not None:
        extra += [fim["sep"], *enc("filename\n")]

    prefix = enc(input_prefix)
    suffix = enc(input_suffix)
    prompt_tokens = list(prompt_tokens or [])
    # prefix:suffix context ratio 3:1 within one batch (utils.hpp)
    n_prefix_take = min(len(prefix), 3 * (n_batch // 4))
    n_suffix_take = min(len(suffix),
                        max(0, (n_batch // 4) - (2 + len(prompt_tokens))))
    n_extra_take = min(max(0, n_ctx - n_batch - 2 * n_predict), len(extra))

    pre_part = [fim["pre"], *prefix[len(prefix) - n_prefix_take:],
                *prompt_tokens]
    suf_part = [fim["suf"], *suffix[:n_suffix_take]]
    first, second = ((suf_part, pre_part) if spm_infill
                     else (pre_part, suf_part))

    bos = md.get("tokenizer.ggml.bos_token_id")
    add_bos = bool(md.get("tokenizer.ggml.add_bos_token", True))
    out = []
    if add_bos and bos is not None:
        out.append(int(bos))
    out = extra[len(extra) - n_extra_take:] + out + first + second
    out.append(fim["mid"])
    return out
