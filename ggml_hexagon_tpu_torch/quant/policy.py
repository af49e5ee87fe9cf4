"""Model quantization policy — per-tensor type selection (the port's own
copy of ggml_hexagon_tpu/quant/policy.py, without the GGUF re-quantize
driver, which waits for the port's GGUF support).

The analog of the reference's llama_model_quantize driver
(src/llama-quant.cpp): an ftype names the mixture, and per-tensor
heuristics bump sensitive tensors (attn_v, ffn_down, output/embedding)
to higher-precision types.  `tensor_type` mirrors llama_tensor_get_type
(llama-quant.cpp:122-310) branch-for-branch for the shipped ftypes —
including the n_gqa / n_expert / has_imatrix switches — because byte
parity with llama-quantize (tools/parity.py) depends on choosing the
SAME type per tensor.  Falcon-specific branches are omitted (arch gate).
"""
from __future__ import annotations

from dataclasses import dataclass

from .formats import GGMLType


# ftype table (llama.h:148-189 subset)
FTYPES = {
    "F16": GGMLType.F16,
    "BF16": GGMLType.BF16,
    "Q8_0": GGMLType.Q8_0,
    "Q6_K": GGMLType.Q6_K,
    "Q5_K_M": GGMLType.Q5_K,
    "Q5_K_S": GGMLType.Q5_K,
    "Q4_K_M": GGMLType.Q4_K,
    "Q4_K_S": GGMLType.Q4_K,
    "Q3_K_M": GGMLType.Q3_K,
    "Q3_K_S": GGMLType.Q3_K,
    "Q3_K_L": GGMLType.Q3_K,
    "Q2_K": GGMLType.Q2_K,
    "Q2_K_S": GGMLType.Q2_K,
    "Q5_0": GGMLType.Q5_0,
    "Q5_1": GGMLType.Q5_1,
    "Q4_0": GGMLType.Q4_0,
    "Q4_1": GGMLType.Q4_1,
    # i-quant mixtures (llama.h ftypes IQ1_S..IQ4_XS)
    "IQ1_S": GGMLType.IQ1_S,
    "IQ1_M": GGMLType.IQ1_M,
    "IQ2_XXS": GGMLType.IQ2_XXS,
    "IQ2_XS": GGMLType.IQ2_XS,
    "IQ2_S": GGMLType.IQ2_S,
    "IQ2_M": GGMLType.IQ2_S,
    "IQ3_XXS": GGMLType.IQ3_XXS,
    "IQ3_S": GGMLType.IQ3_S,
    "IQ3_M": GGMLType.IQ3_S,
    "IQ4_NL": GGMLType.IQ4_NL,
    "IQ4_XS": GGMLType.IQ4_XS,
    "TQ1_0": GGMLType.TQ1_0,
    "TQ2_0": GGMLType.TQ2_0,
}

#: the reference's "low IQ" family branch (llama-quant.cpp:190)
_IQ_LOW = ("IQ1_S", "IQ1_M", "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M")

#: blck-size-incompatible fallback chain (llama-quant.cpp:381-398)
_FALLBACK = {
    GGMLType.TQ1_0: GGMLType.Q4_0, GGMLType.TQ2_0: GGMLType.Q4_0,
    GGMLType.IQ2_XXS: GGMLType.IQ4_NL, GGMLType.IQ2_XS: GGMLType.IQ4_NL,
    GGMLType.IQ2_S: GGMLType.IQ4_NL, GGMLType.IQ3_XXS: GGMLType.IQ4_NL,
    GGMLType.IQ3_S: GGMLType.IQ4_NL, GGMLType.IQ1_S: GGMLType.IQ4_NL,
    GGMLType.IQ1_M: GGMLType.IQ4_NL, GGMLType.Q2_K: GGMLType.IQ4_NL,
    GGMLType.Q3_K: GGMLType.IQ4_NL, GGMLType.IQ4_XS: GGMLType.IQ4_NL,
    GGMLType.Q4_K: GGMLType.Q5_0, GGMLType.Q5_K: GGMLType.Q5_1,
    GGMLType.Q6_K: GGMLType.Q8_0,
}


def _use_more_bits(i_layer: int, n_layers: int) -> bool:
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


@dataclass
class QuantPolicy:
    ftype: str
    n_layer: int
    n_gqa: int = 1          # n_head / n_head_kv (hparams.n_gqa())
    n_expert: int = 1
    has_imatrix: bool = False
    has_output: bool = True  # separate output.weight exists (not tied)

    def tensor_type(self, name: str, shape: tuple[int, ...]) -> GGMLType:
        """Choose the quant type for a tensor (llama_tensor_get_type)."""
        ft = self.ftype
        base = FTYPES[ft]
        if base in (GGMLType.F16, GGMLType.BF16):
            return base
        # 1-D tensors (norms) always stay f32
        if len(shape) == 1:
            return GGMLType.F32
        new_type = self._rules(name, base)
        # block-size fallback chain (llama-quant.cpp:368-398)
        from .formats import TYPE_TRAITS

        nx = shape[-1]
        if TYPE_TRAITS[new_type].block_size > 1 and (
                nx % TYPE_TRAITS[new_type].block_size):
            new_type = _FALLBACK.get(new_type, GGMLType.F16)
            if TYPE_TRAITS[new_type].block_size > 1 and (
                    nx % TYPE_TRAITS[new_type].block_size):
                new_type = GGMLType.F16
        return new_type

    def _rules(self, name: str, base: GGMLType) -> GGMLType:
        ft = self.ftype
        layer = self._layer_of(name)
        nl = self.n_layer
        if name == "output.weight" or (
                not self.has_output and name == "token_embd.weight"):
            if ft in ("IQ2_XXS", "IQ2_XS", "IQ3_XXS", "IQ1_S", "IQ2_S",
                      "IQ2_M", "IQ1_M"):
                return GGMLType.Q5_K
            if base != GGMLType.Q8_0:
                return GGMLType.Q6_K
            return base
        if name == "token_embd.weight":
            if ft in ("IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M"):
                return GGMLType.Q2_K
            if ft in ("IQ2_S", "IQ2_M", "IQ3_XXS"):
                return GGMLType.IQ3_S
            if ft in ("TQ1_0", "TQ2_0"):
                return GGMLType.Q4_K
            if ft in ("Q2_K", "Q2_K_S", "Q3_K_S"):
                return GGMLType.Q2_K
            if ft.startswith("Q3_K"):
                return GGMLType.Q3_K
            return base
        # --- the low-IQ family branch handles its four tensor classes and
        # falls through to base for everything else (llama-quant.cpp:190)
        if ft in _IQ_LOW:
            if ".attn_v.weight" in name:
                if self.n_gqa >= 4 or self.n_expert >= 4:
                    return GGMLType.Q4_K
                return (GGMLType.IQ3_S if ft in ("IQ2_S", "IQ2_M")
                        else GGMLType.Q2_K)
            if self.n_expert == 8 and ".attn_k.weight" in name:
                return GGMLType.Q4_K
            if "ffn_down" in name:
                if layer is not None and layer < nl // 8:
                    return (GGMLType.IQ3_S if ft in ("IQ2_S", "IQ2_M")
                            else GGMLType.Q2_K)
                return base
            if "attn_output.weight" in name:
                if self.n_expert == 8:
                    return GGMLType.Q5_K
                if ft in ("IQ1_S", "IQ1_M"):
                    return GGMLType.IQ2_XXS
                if ft in ("IQ2_S", "IQ2_M"):
                    return GGMLType.IQ3_S
            return base
        if ".attn_v.weight" in name:
            new_type = base
            if ft == "Q2_K":
                new_type = (GGMLType.Q4_K if self.n_gqa >= 4
                            else GGMLType.Q3_K)
            elif ft == "Q2_K_S" and self.n_gqa >= 4:
                new_type = GGMLType.Q4_K
            elif ft == "IQ3_XXS":
                new_type = (GGMLType.Q4_K if self.n_gqa >= 4
                            else (GGMLType.IQ3_XXS if self.has_imatrix
                                  else GGMLType.IQ3_S))
            elif ft in ("IQ3_S",) and self.n_gqa >= 4:
                new_type = GGMLType.Q4_K
            elif ft == "IQ3_M":
                new_type = GGMLType.Q4_K
            elif ft == "Q3_K_M":
                new_type = (GGMLType.Q5_K if (layer or 0) < 2
                            else GGMLType.Q4_K)
            elif ft == "Q3_K_L":
                new_type = GGMLType.Q5_K
            elif ft in ("IQ4_NL", "IQ4_XS") and self.n_gqa >= 4:
                new_type = GGMLType.Q5_K
            elif ft in ("Q4_K_M", "Q5_K_M") and layer is not None \
                    and _use_more_bits(layer, nl):
                new_type = GGMLType.Q6_K
            elif ft == "Q4_K_S" and (layer or 0) < 4:
                new_type = GGMLType.Q5_K
            if self.n_expert == 8:
                new_type = GGMLType.Q8_0
            return new_type
        if ".attn_k.weight" in name:
            if self.n_expert == 8:
                return GGMLType.Q8_0
            if ft == "IQ3_XXS":
                return GGMLType.IQ2_S
            return base
        if ".attn_q.weight" in name:
            if ft == "IQ3_XXS":
                return GGMLType.IQ2_S
            return base
        if "ffn_down" in name:
            i = layer if layer is not None else 0
            if ft == "Q2_K":
                return GGMLType.Q3_K
            if ft == "Q2_K_S":
                return GGMLType.Q4_K if i < nl // 8 else base
            if ft == "IQ3_XXS" and not self.has_imatrix:
                return GGMLType.Q4_K if i < nl // 8 else GGMLType.Q3_K
            if ft == "Q3_K_M":
                return (GGMLType.Q5_K if i < nl // 16 else GGMLType.Q4_K)
            if ft == "IQ3_M" and (i < nl // 8 or (
                    self.n_expert == 8 and _use_more_bits(i, nl))):
                return GGMLType.Q4_K
            if ft == "Q3_K_L":
                return GGMLType.Q5_K
            if ft == "Q4_K_M":
                return GGMLType.Q6_K if _use_more_bits(i, nl) else base
            if i < nl // 8 and ft in ("IQ4_NL", "IQ4_XS") \
                    and not self.has_imatrix:
                return GGMLType.Q5_K
            if ft == "Q5_K_M":
                return GGMLType.Q6_K if _use_more_bits(i, nl) else base
            if ft == "Q4_K_S" and i < nl // 8:
                return GGMLType.Q5_K
            if ft in ("Q4_0", "Q5_0") and self.has_imatrix and i < nl // 8:
                return (GGMLType.Q4_1 if ft == "Q4_0" else GGMLType.Q5_1)
            return base
        if "attn_output.weight" in name:
            if self.n_expert == 8:
                if ft in ("Q2_K", "IQ3_XXS", "Q3_K_S", "Q3_K_M", "IQ4_NL",
                          "Q4_K_S", "Q4_K_M", "IQ3_S", "IQ3_M", "IQ4_XS"):
                    return GGMLType.Q5_K
                return base
            if ft == "Q2_K":
                return GGMLType.Q3_K
            if ft == "IQ3_XXS":
                return GGMLType.IQ3_S
            if ft == "Q3_K_M":
                return GGMLType.Q4_K
            if ft == "Q3_K_L":
                return GGMLType.Q5_K
            if ft == "IQ3_M":
                return GGMLType.Q4_K
            return base
        if "attn_qkv.weight" in name:
            if ft in ("Q3_K_M", "Q3_K_L", "IQ3_M"):
                return GGMLType.Q4_K
            if ft == "Q4_K_M":
                return GGMLType.Q5_K
            if ft == "Q5_K_M":
                return GGMLType.Q6_K
            return base
        return base

    @staticmethod
    def _layer_of(name: str):
        if name.startswith("blk."):
            try:
                return int(name.split(".")[1])
            except ValueError:
                return None
        return None
