from .vocab import Vocab, build_tokenizer
from .spm import SPMTokenizer
from .bpe import BPETokenizer

__all__ = ["Vocab", "build_tokenizer", "SPMTokenizer", "BPETokenizer"]
