"""Quantization format descriptors (the port's own copy of
ggml_hexagon_tpu/quant/formats.py; the port imports nothing of the JAX
package).

TPU-native analog of the reference's type system (ggml/include/ggml.h:351-392
`ggml_type` and ggml/src/ggml-common.h block structs).  We keep the same wire
format (GGUF compatibility) but describe each type by (block_size,
type_size_bytes) so the host can slice packed byte streams, and by a planar
"unpacked" layout used on TPU (see quant/pack.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

QK4_0 = 32
QK4_1 = 32
QK5_0 = 32
QK5_1 = 32
QK8_0 = 32
QK8_1 = 32
QK_K = 256  # super-block size for K-quants (ggml-common.h:89)


class GGMLType(enum.IntEnum):
    """Tensor dtypes, numeric values match ggml_type / GGUF (ggml.h:351-392)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were removed upstream (Q4_2/Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


@dataclass(frozen=True)
class TypeTraits:
    """block_size: elements per block; type_size: bytes per block."""

    block_size: int
    type_size: int
    is_quantized: bool = True


# bytes-per-block mirrors the packed structs in ggml-common.h (not copied —
# derived from the published GGUF format spec).
TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, False),
    GGMLType.F16: TypeTraits(1, 2, False),
    GGMLType.BF16: TypeTraits(1, 2, False),
    GGMLType.F64: TypeTraits(1, 8, False),
    GGMLType.I8: TypeTraits(1, 1, False),
    GGMLType.I16: TypeTraits(1, 2, False),
    GGMLType.I32: TypeTraits(1, 4, False),
    GGMLType.I64: TypeTraits(1, 8, False),
    GGMLType.Q4_0: TypeTraits(QK4_0, 2 + QK4_0 // 2),          # d(f16) + 16B
    GGMLType.Q4_1: TypeTraits(QK4_1, 4 + QK4_1 // 2),          # d,m + 16B
    GGMLType.Q5_0: TypeTraits(QK5_0, 2 + 4 + QK5_0 // 2),      # d, qh(u32), 16B
    GGMLType.Q5_1: TypeTraits(QK5_1, 4 + 4 + QK5_1 // 2),
    GGMLType.Q8_0: TypeTraits(QK8_0, 2 + QK8_0),               # d + 32B
    GGMLType.Q8_1: TypeTraits(QK8_1, 4 + QK8_1),               # d,s + 32B
    GGMLType.Q2_K: TypeTraits(QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),
    GGMLType.Q3_K: TypeTraits(QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: TypeTraits(QK_K, 2 + 2 + 12 + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 2 + 2 + 12 + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 4),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8 + QK_K // 32 + 4),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + 4 * 13),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + 64),
}


def row_size(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes for n_elements (must be a multiple of block_size)."""
    tt = TYPE_TRAITS[ggml_type]
    assert n_elements % tt.block_size == 0, (
        f"{ggml_type.name}: {n_elements} not a multiple of {tt.block_size}"
    )
    return n_elements // tt.block_size * tt.type_size


def is_quantized(ggml_type: GGMLType) -> bool:
    return TYPE_TRAITS[ggml_type].is_quantized
