from .reader import GGUFReader, GGUFTensorInfo, GGUFValueType, GGUFFormatError
from .writer import GGUFWriter

__all__ = ["GGUFReader", "GGUFTensorInfo", "GGUFValueType", "GGUFFormatError", "GGUFWriter"]
